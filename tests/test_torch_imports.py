"""Import hygiene of the PyTorch port: ``repro_torch`` imports neither JAX
nor anything of the reference package ``repro``, so it runs where JAX is
not installed (the machine with the card)."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    mods = list(_modules())
    assert "repro_torch.kernels.masked_agg" in mods
    assert {"repro_torch.scale", "repro_torch.scale.buffer",
            "repro_torch.scale.participation",
            "repro_torch.scale.sparse_state"} <= set(mods)
    assert {"repro_torch.experiments.search",
            "repro_torch.paper.asha"} <= set(mods)
    # the LM sweep task and dense decode
    names = {"repro_torch.data.sources": ["traced_lm_source"],
             "repro_torch.experiments.tasks": ["LMTask",
                                               "make_traced_lm_task"],
             "repro_torch.experiments.grid": ["get_task"],
             "repro_torch.models.attention": ["decode_attention"],
             # the model zoo's dense and MoE families, the flash padding
             "repro_torch.models.moe": ["moe_init", "moe_apply",
                                        "_capacity"],
             "repro_torch.configs": ["MoEConfig", "SSMConfig", "ShapeConfig",
                                     "INPUT_SHAPES", "applicable_shapes",
                                     "long_context_capable"],
             "repro_torch.configs.gemma2_9b": ["CONFIG"],
             "repro_torch.configs.deepseek_coder_33b": ["CONFIG"],
             "repro_torch.configs.granite_34b": ["CONFIG"],
             "repro_torch.configs.mixtral_8x22b": ["CONFIG"],
             "repro_torch.configs.llama4_maverick_400b_a17b": ["CONFIG"],
             "repro_torch.kernels.flash_attention": ["padded_head_dim",
                                                     "MAX_HEAD_DIM"]}
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"for m, ns in {names!r}.items():\n"
            "    for n in ns:\n"
            "        getattr(importlib.import_module(m), n)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.') "
            "or k == 'triton' or k.startswith('triton.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imported: {out.stdout.strip()}"


def test_source_scan_finds_no_jax_or_reference_imports():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                         r"from\s+repro(\.|\s+import)|import\s+repro(\.|\s|$))",
                         re.M)
    hits = [f"{p.relative_to(SRC)}: {m.group(0).strip()}"
            for p in PORT.rglob("*.py")
            for m in pattern.finditer(p.read_text())]
    assert hits == []
