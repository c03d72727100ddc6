"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

They define what the Triton kernel in ``repro_torch.kernels.masked_agg``
computes. The kernel's wrapper runs them for CPU tensors only, the CPU
tests hold them against the JAX package, and ``chip_smoke.py`` holds the
kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# Branch opcodes of the fused aggregation (match repro.kernels.masked_agg).
OP_MEAN = 0      # fedpbc / fedavg: guarded active-client mean
OP_ALL = 1       # fedavg_all: all-client delta mean
OP_KNOWN_P = 2   # fedavg_known_p: 1/(m * p_i) delta weighting


def masked_agg_ref(x: torch.Tensor, mask: torch.Tensor,
                   prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FedPBC server aggregation (Alg. 1 line 11): mean over active clients.

    x: [m, n] stacked client parameters; mask: [m] bool/0-1.
    out: [n] fp32 = sum_i mask_i x_i / max(1, sum mask). With ``prev`` ([n])
    an empty active set returns ``prev`` instead of the zero vector.
    """
    mk = mask.float()
    n_active = mk.sum()
    out = (x.float() * mk[:, None]).sum(0) / n_active.clamp_min(1.0)
    if prev is None:
        return out
    return torch.where(n_active > 0, out, prev.float())


def fused_masked_agg_ref(x: torch.Tensor, mask: torch.Tensor,
                         op: Union[int, torch.Tensor], prev: torch.Tensor,
                         p: torch.Tensor) -> torch.Tensor:
    """The fused family aggregation, every branch computed and one selected
    per trajectory by ``op``; fp32 arithmetic, the reference's weight
    expressions (``mask / m``, ``mask / max(p, 1e-3) / m``).

    Single trajectory: x [m, n], mask [m], op scalar, prev [n], p [m];
    batched: a leading [B] axis on every argument. Returns fp32 [n] / [B, n].
    """
    if x.dim() == 2:
        op = torch.as_tensor(op, device=x.device).reshape(1)
        return fused_masked_agg_ref(x[None], mask[None], op, prev[None],
                                    p[None])[0]
    m = x.shape[1]
    xf = x.float()
    mk = mask.float()
    prev = prev.float()
    n_active = mk.sum(1, keepdim=True)                       # [B, 1]
    mean_agg = (xf * mk[..., None]).sum(1) / n_active.clamp_min(1.0)
    mean_out = torch.where(n_active > 0, mean_agg, prev)
    delta = xf - prev[:, None]
    all_out = prev + (delta * (mk / m)[..., None]).sum(1)
    w_kp = mk / p.float().clamp_min(1e-3) / m
    kp_out = prev + (delta * w_kp[..., None]).sum(1)
    op = torch.as_tensor(op, device=x.device).reshape(-1, 1)
    return torch.where(op == OP_MEAN, mean_out,
                       torch.where(op == OP_ALL, all_out, kp_out))
