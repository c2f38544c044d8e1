"""Device interval of the port's ``c2m.model.flow_embedder`` span per
profiled request: the SPADE generator's U-net over [warped image, flow,
occlusion], busy and idle alike (CUDA events at the span's edges). None
in a cell whose generator has no flow embedder."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "serve", "c2m.model.flow_embedder",
                               "device_ms")
