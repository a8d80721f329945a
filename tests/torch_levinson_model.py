"""A step-for-step torch model of levinson_kernel (csrc/analysis_scans.cu),
imported by tests/test_torch_analysis_scans.py (the model against the JAX
package on the CPU) and tests/test_torch_cuda.py (the kernel against the
model on the card, bit for bit).

The kernel takes each step's numerator in Schur form instead of as the
sum num_k = sum_i a_k[i] c[k+1-i]. It carries the forward and backward
correlations of a_k with the lags,

    F_k[m] = sum_i a_k[i] c[m-i],   B_k[m] = sum_i a_k[k-i] c[m-i],

(F_0 = B_0 = c), which the step's gamma updates elementwise,

    F_{k+1}[m] = F_k[m] + gamma_k B_k[m-1],
    B_{k+1}[m] = B_k[m-1] + gamma_k F_k[m],

so num_{k+1} = F_{k+1}[k+2] = F_k[k+2] + gamma_k B_k[k+1]: one multiply and
one add after the divide, from two values known before it. No sum is
taken. No entry past k + 1 of a_k (the plain version's `tail`: 0, or NaN
once a gamma is not finite) enters num: num_{k+1} is NaN when gamma_k is
not finite instead, which is when the plain version's tail turns NaN and
carries NaN into every later sum. A lag first reaches num through F_0 = c,
as it reaches the plain sum through a[0] = 1, so NaN and +-Inf land in the
same places. The update of a runs over every entry with a[k + 1 - i] read
as 0 for i > k + 1, as the plain version's does. The kernel keeps F and B
in a frame that moves with the step and spreads a row over G lanes; that
only moves values, so the model runs on flat indices. Every float
operation here is one IEEE operation, rounded on its own, as the kernel's
intrinsics are.
"""

import torch

FLT_EPSILON = 1.1920928955078125e-07
SLOTS = 5  # entries a lane


def lanes_for(order: int) -> int:
    """The kernel's lanes a row: the least power of two G with
    SLOTS * G >= order + 1."""
    g = 1
    while SLOTS * g < order + 1:
        g *= 2
    return g


def levinson_schur(ac: torch.Tensor, order: int, with_parcor: bool = False):
    """ac [rows, order + 1] float64 on the CPU -> lpc [rows, order] (and
    parcor), in the kernel's order of operations."""
    width = lanes_for(order) * SLOTS
    rows = ac.shape[0]
    c = ac.new_zeros((rows, width))
    c[:, :order + 1] = ac
    silent = c[:, 0].abs() < FLT_EPSILON
    c0 = torch.where(silent, 1.0, c[:, 0])
    c[:, 0] = c0
    f_corr, b_corr = c.clone(), c.clone()
    i = torch.arange(width)
    a = ac.new_zeros((rows, width))
    a[:, 0] = 1.0
    ek = c0
    num = (0.0 + c[:, 1]) + 0.0 * c0
    nan = torch.full_like(num, float("nan"))
    zero = ac.new_zeros(())
    neg_gammas = []
    for k in range(order):
        f = f_corr[:, k + 2] if k + 2 < width else f_corr[:, 0]
        b = b_corr[:, k + 1]
        shifted = torch.cat([ac.new_zeros((rows, 1)), b_corr[:, :-1]], -1)
        q = num / -ek
        gamma = torch.where(ek.abs() > 0, q, 0.0)
        num = torch.where(torch.isfinite(gamma), f + gamma * b, nan)
        ek = ek * (1.0 - gamma * gamma)
        g = gamma[:, None]
        f_corr, b_corr = f_corr + g * shifted, shifted + g * f_corr
        rev = torch.where(i <= k + 1, a[:, (k + 1 - i).clamp(min=0)], zero)
        a = a + g * rev
        neg_gammas.append(-gamma)
    lpc = torch.where(silent[:, None], 0.0, a[:, 1:order + 1])
    if not with_parcor:
        return lpc
    parcor = torch.where(silent[:, None], 0.0, torch.stack(neg_gammas, -1))
    return lpc, parcor
