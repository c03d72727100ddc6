"""Roofline terms of one step on the H100 (port of
``repro.launch.roofline``).

    compute term    = counted FLOPs / peak FLOP/s
    memory term     = counted bytes / HBM bytes/s
    collective term = collective bytes / link bytes/s

The counts come from ``repro_torch.launch.dryrun``: the step run on the
meta device, flops and bytes summed over its aten ops. On one card its
``coll_bytes`` is 0. On the reference's production meshes the step is a
DTensor program and the row is rank 0's: its local flops and bytes, and
the output bytes of its functional collectives by kind (the reference's
convention, ``CollectiveStats``). The reference parses XLA's HLO text for
its collectives; the port counts the ops DTensor runs. The sharded sweep's
all-gathers over ``"model"`` (``repro_torch.sharding.pool.ModelAxis``) are
counted from the mesh and the shapes (``collective_stats``). Both go at
the link rate (``CollectiveStats.t_collective``, ``Roofline``).

Hardware model: the NVIDIA H100 data sheet's dense peaks, by card variant
(``peak_rates``); the module constants are the SXM part's at 700 W: 989
TFLOP/s bf16, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s each way (900 GB/s
both ways, the data sheet's figure).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

PEAK_FLOPS = 989e12       # bf16 dense tensor-core flop/s, H100 SXM
HBM_BW = 3.35e12          # bytes/s, H100 SXM
LINK_BW = 450e9           # bytes/s each way, NVLink 4 (900 GB/s both ways)


def peak_rates(name: str):
    """``(bytes/s, fp32 flop/s, bf16 dense tensor-core flop/s)`` of the card
    named ``name`` (``torch.cuda.get_device_name``), from NVIDIA's data
    sheet: the PCIe, NVL or (otherwise) SXM H100."""
    if "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "NVL" in name:
        return 3.9e12, 60e12, 835e12
    return HBM_BW, 67e12, PEAK_FLOPS


@dataclass
class CollectiveStats:
    """Per-rank collective traffic by kind (``"all-gather"``): the output
    bytes of each op and the number of ops, the reference's convention."""

    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def t_collective(self) -> float:
        """Seconds at the NVLink rate (``LINK_BW``, 450 GB/s each way on
        the H100 SXM data sheet): the least time the bytes take between
        cards."""
        return self.total_bytes / LINK_BW


def collective_stats(model: int, *, rows: int, clients: int,
                     group_bytes: Sequence[int], rounds: int,
                     final_bytes: Sequence[int] = (),
                     sequence: Optional[Tuple[int, int, int]] = None,
                     exchanges: Sequence[Tuple[str, int, int]] = ()
                     ) -> CollectiveStats:
    """The collectives one rank of the sharded sweep makes over a
    ``"model"`` axis of ``model`` ranks (none when ``model`` is 1), for
    ``rows`` trajectories of ``clients`` clients (m, or C in cohort mode)
    each. Split by clients (``pool.ModelAxis``), all-gathers:

    - every round, one gather of the local updates per parameter group
      (``group_bytes[g]``: one client's bytes of group ``g``) and one of
      the per-client losses (fp32);
    - at the end, one gather of each client-state leaf (``final_bytes``:
      one client's bytes of each clients buffer and optimizer leaf).

    Split by sequence (``sequence = (layers, local_steps, kv_bytes)``,
    ``pool.SequenceAxis``; ``kv_bytes`` one client's bytes of one layer's
    K over the whole sequence, ``b * T * kv_heads * head_dim * itemsize``):

    - every local step, an all-gather of K and one of V a layer, and in
      the backward an all-reduce of each of their gradients (over the
      whole sequence, zero past the rank's prefix);
    - every local step, the other layers' exchanges (``exchanges``,
      ``(kind, bytes, count)``: ``count`` collectives of ``kind`` a step,
      each moving ``bytes`` a client; ``sequence_exchanges`` of the
      model's config);
    - every local step, one all-reduce of the gradient per parameter
      group; every round, one of the per-client losses (fp32);
    - no final gather: every rank holds all the clients.

    Bytes are each collective's output, ``rows * clients * bytes a
    client``."""
    if model <= 1:
        return CollectiveStats()
    if sequence is not None:
        layers, steps, kv = sequence
        kv_all = 2 * layers * rows * clients * kv     # K and V, a step
        grads = sum(b * rows * clients for b in group_bytes)
        nbytes = {"all-gather": steps * kv_all,
                  "all-reduce": steps * (kv_all + grads) + 4 * rows * clients}
        count = {"all-gather": steps * 2 * layers,
                 "all-reduce": steps * (2 * layers + len(group_bytes)) + 1}
        for kind, b, n in exchanges:
            nbytes[kind] += steps * n * b * rows * clients
            count[kind] += steps * n
        return CollectiveStats({k: rounds * v for k, v in nbytes.items()},
                               {k: rounds * v for k, v in count.items()})
    per = [b * rows * clients for b in group_bytes] + [4 * rows * clients]
    fin = [b * rows * clients for b in final_bytes]
    return CollectiveStats({"all-gather": rounds * sum(per) + sum(fin)},
                           {"all-gather": rounds * len(per) + len(fin)})


def sequence_exchanges(cfg, *, batch: int, seq_len: int, ranks: int,
                       itemsize: int = 4):
    """The exchanges one local step (forward and backward) of the LM
    ``cfg`` (a ``ModelConfig``) makes under a sequence split over
    ``ranks`` (``pool.SequenceAxis``) besides the attention layers' K/V
    gathers, as ``collective_stats``'s ``exchanges``: ``(kind, bytes a
    client, count)`` for one client's ``batch`` sequences of ``seq_len``
    tokens (activations ``itemsize`` bytes, states fp32). Each exchange
    runs one collective in the forward, and one in the backward where a
    gradient flows back:

    - RWKV6 layer: the time and channel mixes' token shifts
      (``prev_rows``, a gather of ``ranks`` rows of ``d`` each and the
      all-reduce of its gradient) and the WKV6 state's ``carry_in`` (a
      gather of ``ranks`` fp32 states ``[H, D, D]`` and log decays ``[H,
      D]`` a sequence, and its gradient's all-reduce);
    - Mamba layer: the conv's ``prev_rows`` (``conv_width - 1`` rows of
      ``d_inner``) and the scan's ``carry_in`` (a state and a log decay
      ``[d_inner, N]`` a sequence);
    - MoE layer: the gather of the expert counts ``[ranks, E]`` a sequence
      (no gradient) and the ``all_sum`` of the probability sums ``[E]``,
      forward and backward."""
    out = []

    def pair(nbytes, n=1):          # forward gather, backward all-reduce
        out.extend([("all-gather", ranks * batch * nbytes, n),
                     ("all-reduce", ranks * batch * nbytes, n)])

    d = cfg.d_model
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if kind == "rwkv":
            hd = cfg.rwkv.head_dim
            pair(d * itemsize, 2)
            pair((d // hd) * (hd * hd + hd) * 4)
        elif kind == "ssm":
            di, n = d * cfg.ssm.expand, cfg.ssm.state_dim
            pair((cfg.ssm.conv_width - 1) * di * itemsize)
            pair(2 * di * n * 4)
        if cfg.moe is not None and kind != "rwkv" and cfg._is_moe_layer(i):
            e = cfg.moe.num_experts
            out.extend([("all-gather", ranks * batch * e * 4, 1),
                        ("all-reduce", batch * e * 4, 2)])
    return out


def attention_pairs(t: int, window: int = 0, q_offset: int = 0) -> int:
    """Allowed (query, key) pairs of one head of ``t`` queries at absolute
    positions ``q_offset + i`` against the keys up to the last of them
    (``q_offset + t``), under the causal mask and a sliding ``window`` (0:
    none): the sum over query positions ``p`` of ``min(p + 1, window or
    p + 1)``."""
    if q_offset:
        return (attention_pairs(q_offset + t, window)
                - attention_pairs(q_offset, window))
    w = window if window else t
    if w >= t:
        return t * (t + 1) // 2
    return w * (w + 1) // 2 + (t - w) * w


def flash_work(bh: int, t: int, d: int, window: int, itemsize: int,
               q_offset: int = 0):
    """``{kernel: (flops, bytes)}`` of the three flash kernels on ``q [bh,
    t, d]`` at ``q_offset`` against ``k, v [bh, q_offset + t, d]``
    (``repro_torch.kernels.flash_attention``; self-attention at
    ``q_offset`` 0), counting the causal pairs only (the masked tiles are
    skipped) and each operand moved once:

    - ``fwd``: ``QK^T`` and ``PV`` (4 flops a pair and head dim); reads
      q, k, v, writes o and the fp32 row log-sum-exp;
    - ``dq``: recomputes ``QK^T``, then ``dP = dO V^T`` and ``dQ = dS K``
      (6); reads q, k, v, o, dO and lse, writes dq and delta;
    - ``dkdv``: recomputes ``QK^T`` and ``dP``, then ``dV = P^T dO`` and
      ``dK = dS^T Q`` (8); reads q, k, v, dO, lse and delta, writes dk and
      dv."""
    pairs = bh * attention_pairs(t, window, q_offset)
    row, mat = bh * t * 4, bh * t * d * itemsize
    kmat = bh * (q_offset + t) * d * itemsize
    return {"fwd": (4 * pairs * d, 2 * mat + 2 * kmat + row),
            "dq": (6 * pairs * d, 4 * mat + 2 * kmat + 2 * row),
            "dkdv": (8 * pairs * d, 2 * mat + 4 * kmat + 2 * row)}


def wkv6_work(bh: int, t: int, d: int, heads: int):
    """``{"fwd", "bwd"}: (flops, bytes)`` of the WKV6 function on ``r, k,
    v, w [bh, t, d]`` fp32 with ``u [heads, d]`` and ``s0 [bh, d, d]``
    (``repro_torch.kernels.rwkv6_chunk``):
    each input read once and each output written once, and the flops of
    the step recurrence (``ref.rwkv6_chunk_ref``), per (bh, step):

    - ``fwd``: reads r, k, v, w, u, s0, writes o and S_T; ``r_t S`` (2
      d^2), ``diag(w_t) S`` (d^2), ``S + k_t^T v_t`` (2 d^2) and the bonus
      ``(r_t . (u * k_t)) v_t`` added to ``o_t`` (5 d);
    - ``bwd``: reads r, k, v, w, u, s0, do and dS_T, writes dr, dk, dv,
      dw, du and ds0; the state recomputed (3 d^2), ``dr_t = S do_t``,
      ``dk_t = dS v_t``, ``dv_t = k_t dS`` and ``dw_t = rowsum(dS . S)``
      (2 d^2 each), ``dS <- diag(w_t) dS + r_t^T do_t`` (3 d^2), and the
      bonus's four gradients (13 d).

    The chunked kernels do more flops (pairwise decays, exponentials) and
    move more bytes (the chunk-state workspaces); that is their cost, not
    the function's."""
    steps, mat, state = bh * t, 4 * bh * t * d, 4 * bh * d * d
    return {"fwd": (steps * (5 * d * d + 5 * d),
                    5 * mat + 4 * heads * d + 2 * state),
            "bwd": (steps * (14 * d * d + 13 * d),
                    9 * mat + 8 * heads * d + 3 * state)}


@dataclass
class Roofline:
    """The three terms of one step on ``chips`` cards, each in seconds:
    ``flops``, ``hbm_bytes`` and ``coll_bytes`` are one card's counts (on a
    mesh, rank 0's), ``model_flops`` the step's useful flops over all
    cards (``model_flops_for``)."""

    flops: float                 # per-card counted flops
    hbm_bytes: float             # per-card bytes accessed
    coll_bytes: float            # per-card collective bytes
    chips: int
    model_flops: float = 0.0     # 6*N*D useful flops (global)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        """The reference's row keys (``hlo_*`` hold the counted totals)."""
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops": self.flops,
            "hlo_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "useful_fraction": self.useful_fraction,
        }


def model_flops_for(cfg, shape, *, mode: str) -> float:
    """MODEL_FLOPS = 6 * N_active * D_tokens for training, 2 * N_active *
    D_tokens for a forward, where decode counts one token per sequence."""
    n = cfg.active_param_count()
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    tokens = shape.global_batch           # one new token per sequence
    return 2.0 * n * tokens
