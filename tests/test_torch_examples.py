"""The port's examples (``examples/torch_port/``, twins of the reference's
``examples/*.py``) run on the CPU through their ``main(argv)`` with
``--device cpu``, at small sizes: the quickstart at 120 of its 400 rounds
(FedPBC still beats FedAvg by its own assertion, 2x), the links demo
whole, the launcher wrappers for a few rounds or tokens of reduced
SmolLM-135M. Each checks what its script prints or returns. About 15 s on
one CPU core.
"""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch_port")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_port_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_fedpbc_beats_fedavg(monkeypatch, capsys):
    mod = _load("quickstart")
    monkeypatch.setattr(mod, "ROUNDS", 120)
    out = mod.main(["--device", "cpu"])
    assert out["fedpbc"] < 0.5 * out["fedavg"]
    assert "implicit gossiping wins" in capsys.readouterr().out


def test_unreliable_links_demo(capsys):
    out = _load("unreliable_links_demo").main(["--device", "cpu"])
    assert len(out["traces"]) == 6
    for actives in out["traces"].values():
        assert tuple(actives.shape) == (80, 4) and actives.dtype == torch.bool
    assert out["commits"] > 0
    printed = capsys.readouterr().out
    assert "cross-device: fedpbc, m=10,000, cohort C=256" in printed


def test_train_federated_lm_wrapper(capsys):
    mod = _load("train_federated_lm")
    res = mod.main(["--device", "cpu", "--rounds", "2", "--clients", "2",
                    "--seq", "16", "--batch", "1", "--log-every", "1"])
    assert len(res["losses"]) == 2
    assert all(torch.isfinite(torch.as_tensor(x)).all()
               for x in res["losses"])
    assert "done: 2 rounds" in capsys.readouterr().out


def test_serve_batched_wrapper():
    out = _load("serve_batched").main(["--device", "cpu", "--batch", "2",
                                       "--prompt-len", "4", "--gen", "3"])
    assert tuple(out["ids"].shape) == (2, 3)
