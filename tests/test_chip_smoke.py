"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size through
the same code the GPU run takes, and its refusal to run without a GPU.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(N=4096, n_fft=62, batch=2, serve=(3000, 3500, 5000),
                rec=(2, 16384), chunk=8192, multi_N=8192,
                multi_stft=(2, 4096))


@pytest.mark.parametrize("phases", [
    ("phase_forward_inverse",),
    ("phase_batch",),
    ("phase_serve",),
    ("phase_forward_inverse", "phase_grad"),
    ("phase_record",),
    ("phase_multi",),
], ids=lambda p: p[-1])
def test_phase_passes_at_tiny_size(phases, capsys):
    failed = cs.run([getattr(cs, p) for p in phases], TINY)
    out = capsys.readouterr().out
    assert failed == [], out
    assert "FAIL" not in out, out


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_refuses_without_gpu(argv, capsys):
    """No accelerator: nonzero exit, no result line (no CPU fallback)."""
    assert cs.main(argv) != 0
    assert '"ok"' not in capsys.readouterr().out
