"""Roofline terms of one step on the H100 (port of
``repro.launch.roofline``).

    compute term    = counted FLOPs / peak FLOP/s
    memory term     = counted bytes / HBM bytes/s
    collective term = collective bytes / link bytes/s

The counts come from ``repro_torch.launch.dryrun`` (the step run on the meta
device under ``torch.utils.flop_counter.FlopCounterMode``, bytes summed over
its aten ops). No program of the port has a collective yet (the mesh is
item 6 of ROADMAP.md), so ``coll_bytes`` is 0; the reference parses XLA's
HLO text for it (``collective_stats``), which moves to item 6.

Hardware model: the NVIDIA H100 data sheet's dense peaks, by card variant
(``peak_rates``); the module constants are the SXM part's at 700 W: 989
TFLOP/s bf16, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s each way.
"""
from __future__ import annotations

from dataclasses import dataclass

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


def attention_pairs(t: int, window: int = 0) -> int:
    """Allowed (query, key) pairs of one head of length ``t`` under the
    causal mask and a sliding ``window`` (0: none): the sum over queries
    ``q`` of ``min(q + 1, window or t)``."""
    w = window if window else t
    if w >= t:
        return t * (t + 1) // 2
    return w * (w + 1) // 2 + (t - w) * w


def flash_work(bh: int, t: int, d: int, window: int, itemsize: int):
    """``{kernel: (flops, bytes)}`` of the three flash kernels on ``[bh, t,
    d]`` (``repro_torch.kernels.flash_attention``), counting the causal
    pairs only (the masked tiles are skipped) and each operand moved once:

    - ``fwd``: ``QK^T`` and ``PV`` (4 flops a pair and head dim); reads
      q, k, v, writes o and the fp32 row log-sum-exp;
    - ``dq``: recomputes ``QK^T``, then ``dP = dO V^T`` and ``dQ = dS K``
      (6); reads q, k, v, o, dO and lse, writes dq and delta;
    - ``dkdv``: recomputes ``QK^T`` and ``dP``, then ``dV = P^T dO`` and
      ``dK = dS^T Q`` (8); reads q, k, v, dO, lse and delta, writes dk and
      dv."""
    pairs = bh * attention_pairs(t, window)
    row, mat = bh * t * 4, bh * t * d * itemsize
    return {"fwd": (4 * pairs * d, 3 * mat + mat + row),
            "dq": (6 * pairs * d, 5 * mat + row + mat + row),
            "dkdv": (8 * pairs * d, 4 * mat + 2 * row + 2 * mat)}


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
    ``flops``, ``hbm_bytes`` and ``coll_bytes`` are one card's counts (the
    dry run's step runs on one), ``model_flops`` the step's useful flops
    over all cards (``model_flops_for``)."""

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
