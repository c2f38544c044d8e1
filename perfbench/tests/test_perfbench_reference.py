"""The plain reference agrees with the port at a tiny size in float32 on
the CPU, for one serve request and one train step, through the cell's own
run (the same weights, inputs and draws on both sides)."""

from conftest import run_cell


def test_serve_agrees(tiny_base, capsys):
    rc, result = run_cell(tiny_base, "tiny.serve", capsys=capsys)
    assert rc == 0 and result["correct"] is True
    assert result["checks"]["serve_out_gap"]["value"] < 1e-5


def test_train_step_agrees(tiny_base, capsys):
    rc, result = run_cell(tiny_base, "tiny.train", capsys=capsys)
    assert rc == 0 and result["correct"] is True
    # the first step's losses agree to rounding; the change over three
    # Adam steps moves tiny gradients by a whole step size on a sign
    for name, check in result["checks"].items():
        assert check["value"] < (1e-3 if "change" in name else 1e-5), name
