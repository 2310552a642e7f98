"""The port's five examples (``examples/torch_*.py``) run through their
``main(argv)`` on the CPU at smoke size, each through the port's public
entry points: the quickstart (``resolve_policy``, the surrogate, a train
step, the spectra), PDE training (``get_model``, ``Trainer`` and the
checkpoint manager, resumed), serving (``ServeEngine`` after a quick train),
the streaming state (``stream_init`` / ``stream_chunk`` / ``stream_append``)
and the spectral analysis (Algorithm 1 against the dense oracle). Without a
card, ``--device cuda`` (the default) raises rather than fall back."""
import importlib.util
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_train_pde_surrogate", "torch_serve_llm",
         "torch_long_context_stream", "torch_spectral_analysis")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_smoke():
    out = _load("torch_quickstart").main(["--device", "cpu", "--smoke"])
    assert out["plan"] == "sdpa"
    assert 0 < out["held_out"] < 10 and all(1 <= r <= 16 for r in out["ranks"])


def test_train_pde_surrogate_smoke_resumes(tmp_path):
    mod = _load("torch_train_pde_surrogate")
    argv = ["--device", "cpu", "--smoke", "--ckpt", str(tmp_path / "ck")]
    first = mod.main(argv)
    assert len(first["history"]) == 8 and first["latest_step"] == 8
    assert first["history"][-1]["loss"] < first["history"][0]["loss"]
    again = mod.main(argv)   # resumed at the last step: nothing left to train
    assert again["history"] == [] and again["held_out"] == first["held_out"]


def test_serve_llm_smoke():
    out = _load("torch_serve_llm").main(["--device", "cpu", "--smoke"])
    assert [len(o) for o in out["outs"]] == [2 + 4 * i for i in range(5)]
    assert out["stats"]["requests"] == 5 and out["stats"]["tokens_generated"] == 50
    assert all(0 <= t < 128 for o in out["outs"] for t in o)


def test_long_context_stream_smoke():
    out = _load("torch_long_context_stream").main(["--device", "cpu", "--smoke"])
    assert out["context"] == 1024 and out["finite"]
    assert out["state_bytes"] == (4 * 32 * 2 + 4 * 32 * 16) * 4   # m_max, den; num


def test_spectral_analysis_smoke():
    out = _load("torch_spectral_analysis").main(["--device", "cpu", "--smoke"])
    assert len(out["ranks"]) == 3 and all(1 <= r <= 16 for rs in out["ranks"] for r in rs)
    assert out["dense_err"] < 1e-4


@pytest.mark.parametrize("name", NAMES)
def test_default_device_is_cuda_and_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(SystemExit, match="no CUDA device"):
        _load(name).main(["--smoke"])
