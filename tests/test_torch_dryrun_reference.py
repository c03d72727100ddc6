"""The port's meshed dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``: GSPMD's partitioned programs, XLA's
cost analysis), row for row, on ``16x16`` and ``2x16x16`` at ``reduced()``
SmolLM-135M and short shapes of each mode.

The reference runs in a subprocess: its dry run needs
``--xla_force_host_platform_device_count=512`` set before JAX starts. Both
sides run with ``--no-seq-parallel`` (no activation spec): under JAX 0.9
the reference's train and prefill rows with its default ``"seq"`` spec
fail (``with_sharding_constraint`` refuses the Explicit axes that
``jax.make_mesh`` now gives), so only the batch-only rows can be compared.

What is held, and how closely:
- ``param_bytes`` per device: exact (both shard each leaf by the same spec,
  rounded up);
- ``argument_bytes`` per device: exact after the inputs the two programs
  hold differently, each reckoned from the specs: the port's token ids are
  int64 (torch's index dtype), the reference's int32; the reference's
  train state carries its round counter (int32) and PRNG key (uint32[2]),
  the port's round is a Python int and its step takes the link uniforms
  ``u [1, m]`` (fp32) instead of a key; the reference's decode takes
  ``pos`` as an int32 array, the port as a Python int;
- FLOPs: XLA counts every op (elementwise, reductions, transcendentals),
  the port the products (``flop_registry``) and the flash kernels' causal
  pairs, and where the model axis does not divide the heads the port's
  attention runs whole on every model rank (``spmd.local_attention``;
  how GSPMD splits it is not examined). So train and prefill lie within a
  factor of 2 of the reference's (measured 1.19–1.57), and decode, whose
  products are tiny beside its elementwise work over the cache, below the
  reference's and above an eighth of it (measured 0.20–0.22);
- collectives: both make all-gathers, and a reduction (all-reduce or
  reduce-scatter) wherever the reference makes an all-reduce; the port's
  total bytes lie between an eighth of the reference's and the
  reference's (measured 0.18–0.58). The two propagate layouts each their
  own way (DTensor's rules per op, GSPMD's over the whole program), and
  where DTensor reduces by reduce-scatter it counts 1/n of an all-reduce's
  output for the same sum (no reference row here has a reduce-scatter;
  its CPU partitioner makes all-reduces). The rows are not matched op by
  op.

About 55 s alone, 140 s in a loaded ``-n 6`` run: the reference's rows
(three XLA compiles each) run in two subprocesses, one a mesh, beside the
port's.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    dp_axes,
    make_production_mesh,
    num_clients_for,
)
from repro_torch.models.model import make_cache  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "smollm-135m"
SHORT = {"train_4k": ShapeConfig("train_4k", 128, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 256, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 256, 32, "decode")}
# 2x16x16 first: its training row, the port's slowest, runs while the
# reference's subprocesses compile
ROWS = [(mp, s) for mp in (True, False) for s in SHORT]

REFERENCE = """
import json, math, sys
from repro.launch import dryrun as D              # sets XLA_FLAGS first
import jax
from repro.configs import ShapeConfig, get_config, reduced
from repro.launch.mesh import make_production_mesh
from repro.models.model import init_params
from repro.sharding.specs import infer_pytree_specs

D.INPUT_SHAPES = {k: ShapeConfig(*v) for k, v in json.loads(sys.argv[2]).items()}
D.get_config = lambda arch: reduced(get_config(arch))
cfg = reduced(get_config(sys.argv[1]))
params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
mp = sys.argv[3] == "1"
shardings = infer_pytree_specs(params, make_production_mesh(multi_pod=mp))
pbytes = sum(math.prod(s.shard_shape(p.shape)) * p.dtype.itemsize
             for p, s in zip(jax.tree.leaves(params),
                             jax.tree.leaves(shardings)))
for shape in D.INPUT_SHAPES:
    r = D.lower_pair(sys.argv[1], shape, multi_pod=mp, verbose=False,
                     seq_parallel=False)
    r.pop("trace", None)
    print("ROW " + json.dumps(dict(r, param_bytes=pbytes)), flush=True)
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's rows ``{(multi_pod, shape): row}``, a mesh's read
    when first asked for; its two subprocesses, one a mesh, start with the
    module."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    shapes = {k: [v.name, v.seq_len, v.global_batch, v.mode]
              for k, v in SHORT.items()}
    procs = {mp: subprocess.Popen(
        [sys.executable, "-c", REFERENCE, ARCH, json.dumps(shapes),
         "1" if mp else "0"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for mp in (False, True)}
    rows = {}

    def get(key):
        if key not in rows:
            out, err = procs[key[0]].communicate(timeout=600)
            assert procs[key[0]].returncode == 0, err[-3000:]
            for line in out.splitlines():
                if line.startswith("ROW "):
                    r = json.loads(line[4:])
                    rows[(r["mesh"] == "2x16x16", r["shape"])] = r
        return rows[key]

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _index_bytes(shape: ShapeConfig, mesh) -> int:
    """Rank 0's token-id elements of the step's inputs (tokens and labels
    in training, the prompt in prefill, the next token in decode)."""
    b = shape.global_batch
    if shape.mode == "train":
        m = num_clients_for(mesh)
        full = (m, 1, b // m, shape.seq_len)
        return 2 * _elems(full, steps._batch_spec(full, mesh), mesh)
    if shape.mode == "prefill":
        full = (b, shape.seq_len)
        return _elems(full, specs.P(dp_axes(mesh), None), mesh)
    cache = make_cache(reduced(get_config(ARCH)), b, shape.seq_len,
                       device="meta")
    tok_spec = steps.serve_shardings({}, cache, mesh, b)[2]
    return _elems((b, 1), tok_spec, mesh)


def _elems(full, spec, mesh) -> int:
    n = 1
    for d in specs.shard_shape(full, spec, mesh):
        n *= d
    return n


@pytest.mark.parametrize("multi_pod,shape_name", ROWS,
                         ids=[f"{'2x16x16' if mp else '16x16'}-{s}"
                              for mp, s in ROWS])
def test_meshed_row_against_the_reference(reference, monkeypatch, multi_pod,
                                          shape_name):
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", SHORT)
    port = dryrun.lower_pair(ARCH, shape_name, multi_pod=multi_pod,
                             seq_parallel=False, verbose=False,
                             cfg=reduced(get_config(ARCH)))
    ref = reference((multi_pod, shape_name))
    assert port["status"] == "ok", port.get("error")
    assert ref["status"] == "ok", ref.get("error")
    assert port["mesh"] == ref["mesh"]

    assert port["param_bytes"] == ref["param_bytes"]
    shape, mesh = SHORT[shape_name], make_production_mesh(
        multi_pod=multi_pod)
    # int64 ids against int32: 4 more bytes an id
    want = ref["argument_bytes"] + 4 * _index_bytes(shape, mesh)
    if shape.mode == "train":
        want += -4 - 8 + 4 * num_clients_for(mesh)    # round, key; u
    elif shape.mode == "decode":
        want -= 4                                       # pos
    assert port["argument_bytes"] == want

    ratio = port["hlo_flops"] / ref["hlo_flops"]
    if shape.mode == "decode":
        assert 1 / 8 <= ratio <= 1, ratio
    else:
        assert 1 / 2 <= ratio <= 2, ratio

    pc, rc = port["collectives"], ref["collectives"]
    assert "all-gather" in pc and "all-gather" in rc
    if "all-reduce" in rc:
        assert {"all-reduce", "reduce-scatter"} & set(pc), pc
    assert set(pc) <= {"all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all"}
    total = port["coll_bytes"] / ref["coll_bytes"]
    assert 1 / 8 <= total <= 1, total
