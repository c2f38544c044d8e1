"""The port's copy of ``c2m_tpu/utils/html.py``, held to the original by
``tests/test_torch_evaluator.py``.

Minimal HTML gallery writer (reference: src/utils/html.py via `dominate`;
we emit the same structure — auto-refreshing index of image rows with
captions — with stdlib string templating, no extra dependency)."""

from __future__ import annotations

import html
import os
from typing import List, Sequence


class HTMLGallery:
    def __init__(self, web_dir: str, title: str, refresh: int = 1):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.title = title
        self.refresh = refresh
        self.rows: List[str] = []
        os.makedirs(self.img_dir, exist_ok=True)

    def add_header(self, text: str) -> None:
        self.rows.append(f"<h3>{html.escape(text)}</h3>")

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   links: Sequence[str], width: int = 512) -> None:
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                f'<td style="word-wrap:break-word" halign="center" valign="top">'
                f'<p><a href="images/{link}"><img style="width:{width}px" '
                f'src="images/{im}"></a><br>{html.escape(txt)}</p></td>')
        self.rows.append(
            '<table border="1" style="table-layout:fixed"><tr>'
            + "".join(cells) + "</tr></table>")

    def save(self) -> None:
        refresh = (f'<meta http-equiv="refresh" content="{self.refresh}">'
                   if self.refresh else "")
        doc = (f"<!DOCTYPE html><html><head><title>{html.escape(self.title)}"
               f"</title>{refresh}</head><body>" + "\n".join(self.rows)
               + "</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(doc)
