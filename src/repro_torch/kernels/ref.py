"""Plain PyTorch versions of the half-sweep arithmetic.

`field_decision_update` is THE half-sweep body: eqn 2 (tanh activation,
additive RNG, comparator sign, masked write) in one place.  The scan
backend ("sparse") loops over it; the CUDA kernel in `sweep_fused`
reproduces the same sequence term for term.  Counterpart of
``repro.kernels.ref``.
"""
from __future__ import annotations

import torch


def decision_value(I, gain, off, rand_gain, comp_off, beta, u):
    """Pre-comparator decision of eqn 2.  Op order is load-bearing:
    ``act = tanh((beta*gain)*(I+off))``, then ``(act + rand_gain*u) +
    comp_off``, every step rounded to float32 on its own."""
    beta = torch.as_tensor(beta, dtype=torch.float32, device=I.device)
    if beta.ndim == 1:
        beta = beta[:, None]
    act = torch.tanh(beta * gain * (I + off))
    return act + rand_gain * u + comp_off


def field_decision_update(m, I, gain, off, rand_gain, comp_off,
                          update_mask, beta, u):
    """Eqn 2 on a precomputed neuron input I: the shared half-sweep tail.

    m/I/u: (B, N);  gain/off/rand_gain/comp_off: (N,);  update_mask: (N,)
    bool;  beta: scalar or (B,) per-chain inverse temperature.
    """
    decision = decision_value(I, gain, off, rand_gain, comp_off, beta, u)
    new = torch.where(decision >= 0.0, 1.0, -1.0).to(m.dtype)
    return torch.where(update_mask, new, m)


def scatter_edge_slots(codes, edges, slot_ij, slot_ji, degree, n_nodes):
    """Scatter (E,) edge-list values into the (D, N) slot layout, both
    directions: out[slot_ij[e], edges[e, 0]] = out[slot_ji[e], edges[e, 1]]
    = codes[e].  edges/slot tables: int64 tensors on codes' device."""
    out = torch.zeros((degree, n_nodes), dtype=codes.dtype,
                      device=codes.device)
    out[slot_ij, edges[:, 0]] = codes
    out[slot_ji, edges[:, 1]] = codes
    return out


def sparse_neuron_input(m, nbr_idx, nbr_w, h):
    """Eqn 1 on the fixed-degree slot layout: I = Σ_d w_d ⊙ m[:, idx_d] + h.

    m: (B, N);  nbr_idx/nbr_w: (D, N).  Slots accumulate in ascending-d
    order from zero and ``+ h`` comes last — the order the CUDA kernel
    uses, so the two agree bit for bit (``w * m`` with m = ±1 is exact).
    """
    acc = torch.zeros((m.shape[0], nbr_idx.shape[1]), dtype=torch.float32,
                      device=m.device)
    for d in range(nbr_idx.shape[0]):
        acc = acc + nbr_w[d][None, :] * m.index_select(1, nbr_idx[d])
    return acc + h


def pbit_sparse_half_sweep_ref(m, nbr_idx, nbr_w, h, gain, off, rand_gain,
                               comp_off, update_mask, beta, u):
    """One colour half-sweep on the slot layout."""
    I = sparse_neuron_input(m, nbr_idx, nbr_w, h)
    return field_decision_update(m, I, gain, off, rand_gain, comp_off,
                                 update_mask, beta, u)
