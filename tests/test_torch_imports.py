"""Import hygiene of the PyTorch port: ``repro_torch`` imports neither JAX
nor anything of the reference package ``repro`` or of the reference's
``benchmarks`` (whose suites import JAX), so it runs where JAX is not
installed (the machine with the card)."""
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
    # the last seven suites of benchmarks/run.py
    assert {f"repro_torch.paper.{m}" for m in (
        "common", "extensions", "kernels_bench", "roofline", "scale",
        "throughput", "sweep_throughput", "lm_sweep")} <= set(mods)
    assert "repro_torch.models.ssm" in mods
    # the analysis gate
    assert {"repro_torch.analysis", "repro_torch.analysis.lint",
            "repro_torch.analysis.rules", "repro_torch.analysis.baseline",
            "repro_torch.analysis.sanitize",
            "repro_torch.analysis.__main__"} <= set(mods)
    assert {"repro_torch.checkpointing",
            "repro_torch.checkpointing.checkpoint", "repro_torch.kernels.ops",
            "repro_torch.launch.roofline", "repro_torch.launch.steps",
            "repro_torch.launch.dryrun"} <= set(mods)
    # the production meshes' placements
    assert {"repro_torch.sharding.specs",
            "repro_torch.sharding.spmd"} <= set(mods)
    # the LM sweep task and dense decode
    names = {"repro_torch.data.sources": ["traced_lm_source"],
             "repro_torch.experiments.tasks": ["LMTask",
                                               "make_traced_lm_task"],
             "repro_torch.experiments.grid": ["get_task"],
             "repro_torch.models.attention": ["decode_attention",
                                              "cross_attention"],
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
                                                     "MAX_HEAD_DIM"],
             # the hybrid, vlm and audio families
             "repro_torch.models.ssm": ["ssm_leaves", "init_leaf",
                                        "ssm_apply", "ssm_init_state",
                                        "selective_scan",
                                        "selective_scan_steps",
                                        "FP32_LEAVES"],
             "repro_torch.models.model": ["FAMILIES"],
             "repro_torch.configs.jamba_1_5_large_398b": ["CONFIG"],
             "repro_torch.configs.llama_3_2_vision_90b": ["CONFIG"],
             "repro_torch.configs.seamless_m4t_medium": ["CONFIG"],
             # parameter groups: the zoo's training
             "repro_torch.core.params": ["Groups", "gmap", "first"],
             "repro_torch.core.federated": ["one_group"],
             # launch and checkpointing
             "repro_torch.checkpointing": ["save", "restore", "latest_step"],
             "repro_torch.kernels.ops": ["masked_agg_pytree",
                                         "gqa_flash_attention"],
             "repro_torch.launch.roofline": ["Roofline", "model_flops_for",
                                             "peak_rates", "CollectiveStats",
                                             "collective_stats"],
             # the sweep's multi-device split
             "repro_torch.launch.mesh": ["Mesh", "make_batch_mesh",
                                         "make_2d_mesh", "make_host_mesh"],
             "repro_torch.sharding.pool": ["Pool", "ModelAxis", "pool_for",
                                           "worker_context",
                                           # the sequence split
                                           "SequenceAxis", "WorkerContext"],
             "repro_torch.experiments.shard": ["AUTO", "resolve_batch_mesh",
                                               "pad_batch", "shard_batch",
                                               "run_sharded",
                                               "run_sharded_2d",
                                               "SEQUENCE_SPEC",
                                               "sequence_split"],
             "repro_torch.launch.steps": ["make_train_step",
                                          "make_prefill_step",
                                          "make_serve_step",
                                          "train_input_specs",
                                          "make_fed_setup", "_batch_spec",
                                          "train_shardings",
                                          "_cache_leaf_spec", "_tp2d_spec",
                                          "serve_shardings",
                                          "placed_train_inputs",
                                          "placed_prefill_inputs",
                                          "placed_serve_inputs"],
             "repro_torch.launch.dryrun": ["count_step", "lower_pair",
                                           "count_step_meshed", "run_rank0",
                                           "LocalCounter", "_act_spec"],
             # the production meshes and their placements
             "repro_torch.launch.mesh": ["make_production_mesh", "dp_axes",
                                         "num_clients_for"],
             "repro_torch.sharding": ["P", "spec_for_shape",
                                      "infer_pytree_specs", "placements",
                                      "activation_sharding",
                                      "activation_spec", "maybe_constrain",
                                      "set_activation_spec", "set_mesh"],
             "repro_torch.sharding.specs": ["leaf_spec", "_moe_expert_spec",
                                            "shard_shape", "sequence_axis",
                                            "sequence_parallel"],
             "repro_torch.sharding.spmd": ["simulated_mesh",
                                           "distribute_empty",
                                           "LayoutFixups", "RETRIED",
                                           "view_placements",
                                           "local_attention", "local_wkv6"],
             "repro_torch.core.params": ["Leaves", "lead_view"],
             # the suites and the sweep's leftovers
             "repro_torch.experiments": ["seed_base_probs",
                                         "make_vmap_run_rounds",
                                         "with_label_noise"],
             "repro_torch.experiments.grid": ["seed_base_probs"],
             "repro_torch.experiments.sweep": ["make_vmap_run_rounds"],
             "repro_torch.experiments.tasks": ["with_label_noise"],
             "repro_torch.paper.common": ["run_training", "accuracy",
                                          "Timer"],
             "repro_torch.paper.run": ["SUITE_INFO", "main"],
             # the analysis gate
             "repro_torch.analysis": ["lint_paths", "lint_text",
                                      "STEP_CONTEXTS", "HostSyncSanitizer",
                                      "assert_no_new_runners",
                                      "RunnerSanitizer"],
             "repro_torch.analysis.sanitize": ["runner_count", "SyncEvent"]}
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"for m, ns in {names!r}.items():\n"
            "    for n in ns:\n"
            "        getattr(importlib.import_module(m), n)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.') "
            "or k == 'benchmarks' or k.startswith('benchmarks.') "
            "or k == 'triton' or k.startswith('triton.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imported: {out.stdout.strip()}"


def test_source_scan_finds_no_jax_or_reference_imports():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                         r"from\s+repro(\.|\s+import)|import\s+repro(\.|\s|$)|"
                         r"from\s+benchmarks\b|import\s+benchmarks\b)",
                         re.M)
    examples = SRC.parent / "examples" / "torch_port"
    files = [*PORT.rglob("*.py"), *examples.glob("*.py"),
             SRC.parent / "chip_smoke.py"]
    assert len(files) > len(list(PORT.rglob("*.py"))) + 4
    hits = [f"{p}: {m.group(0).strip()}" for p in files
            for m in pattern.finditer(p.read_text())]
    assert hits == []


def test_static_gate_imports_no_torch():
    """The gate's static half is stdlib only: importing
    ``repro_torch.analysis`` and linting loads neither torch nor JAX nor
    the reference; torch comes with the runtime half."""
    code = ("import sys\n"
            "import repro_torch.analysis as a\n"
            "from repro_torch.analysis import baseline, lint, rules\n"
            f"a.lint_paths([{str(PORT / 'analysis')!r}])\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'jax', 'repro', 'numpy'))\n"
            "a.HostSyncSanitizer\n"
            "print(','.join(bad), 'torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"], out.stdout


def test_run_sharded_2d_takes_the_activation_spec():
    """The sequence split's entry: ``run_sharded_2d``'s keyword-only
    ``activation_spec`` (default None, the clients split) beside ``draws``,
    and the flash wrappers' ``q_offset``."""
    import inspect

    from repro_torch.experiments import shard
    from repro_torch.kernels import flash_attention as fa

    params = inspect.signature(shard.run_sharded_2d).parameters
    assert params["activation_spec"].default is None
    assert params["activation_spec"].kind is inspect.Parameter.KEYWORD_ONLY
    assert "draws" in params
    for fn in (fa.flash_attention, fa.flash_attention_fwd,
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv):
        assert inspect.signature(fn).parameters["q_offset"].default == 0
