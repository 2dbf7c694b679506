"""The RWKV6 scan kernel's order of operations, replayed on the CPU.

``csrc/rwkv_scan.cu`` gives each thread 8 rows x 2 columns of a head's
(D, D) state: it updates each state element exactly as the plain version
does (``w_i S_ij`` then ``+ k_i v_j``, each rounded once), forms each term
of out_j as the plain version forms it, ``r_i (S_ij + u_i (k_i v_j))``, sums
a thread's 8 terms with FMAs and adds the D / 8 row groups' partial sums in
group order.  :func:`kernel_order_scan` replays that order in float32 (an
FMA as a float64 product and sum rounded once to float32), so the claims
the card tests hold the kernel to can be checked here: the final state is
the plain version's bit for bit, and out stays within
``ref.rwkv6_scan_order_bound`` of the plain version's out.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from torch_cases import rwkv_case

ROWS = 8          # csrc/rwkv_scan.cu kRows: state rows per thread


def kernel_order_scan(r, k, v, w, u):
    """(out (B, H, T, D) float32, state (B, H, D, D) float32) in the CUDA
    kernel's order of operations, from a zero state."""
    B, H, T, D = r.shape
    f32, f64 = torch.float32, torch.float64
    S = torch.zeros((B, H, D, D), dtype=f32)
    uu = u.to(f32)[None, :, :, None]                        # (1, H, D, 1)
    outs = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, :, t].to(f32) for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]             # rounded once
        term = S + uu * kv                                   # two roundings
        prod = rt.to(f64)[..., :, None] * term.to(f64)       # exact in f64
        groups = []
        for g in range(D // ROWS):                           # a thread's FMAs
            acc = torch.zeros((B, H, D), dtype=f32)
            for i in range(g * ROWS, (g + 1) * ROWS):
                acc = (acc.to(f64) + prod[..., i, :]).to(f32)
            groups.append(acc)
        out = groups[0]
        for acc in groups[1:]:                               # in group order
            out = out + acc
        outs.append(out)
        S = wt[..., :, None] * S + kv                        # the plain order
    return torch.stack(outs, dim=2), S


@pytest.mark.parametrize("B,H,T,D", [(1, 2, 200, 64), (2, 3, 64, 32),
                                     (1, 2, 96, 16)])
def test_kernel_order_keeps_the_state_and_stays_within_the_order_bound(B, H, T,
                                                                        D):
    r, k, v, w, u = (torch.from_numpy(a) for a in rwkv_case(B, H, T, D, seed=D))
    # rwkv6-7b's decays, exp(-exp(U(-8, -5))): the state and out's terms grow
    # to hundreds, where a sum order matters most
    rng = np.random.default_rng(T)
    w = torch.from_numpy(np.exp(-np.exp(rng.uniform(-8, -5, w.shape)))
                         .astype(np.float32))
    out, state = kernel_order_scan(r, k, v, w, u)
    p_out, p_state = ref.rwkv6_scan(r, k, v, w, u)
    assert torch.equal(state, p_state)
    bound = ref.rwkv6_scan_order_bound(r, k, v, w, u)
    diff = (out.double() - p_out.double()).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())
    assert float(diff.max()) > 0        # the order does differ
