"""L-BFGS / OWL-QN minimizer of the port (counterpart of
``spark_rapids_ml_tpu/ops/lbfgs.py::minimize_lbfgs``).

The JAX package runs the whole optimization as one jitted
``lax.while_loop`` over fixed-size circular history buffers. Here it is a
Python loop over device tensors: each objective evaluation is one data pass
(kernel K3 inside the caller's loss) and ``torch.autograd`` stands in for
``jax.value_and_grad``. The algorithm is the same step for step: Armijo
backtracking with ``max_ls`` halvings on the L1-inclusive objective, the
two-loop recursion over the last ``history`` curvature pairs (a pair is
kept only when ``sᵀy > 1e-10``), a first step of ``1/max(‖d‖, 1)`` while no
pair is stored, and a stop on relative improvement ``<= tol`` or a
non-descent direction. L1 weights switch to OWL-QN: pseudo-gradient,
direction sign alignment and orthant projection in the line search.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch


class LbfgsResult(NamedTuple):
    w: torch.Tensor   # (p,) solution
    f: float          # final objective (incl. L1 term)
    n_iter: int       # iterations taken
    converged: bool


def _pseudo_gradient(w: torch.Tensor, g: torch.Tensor, l1w: torch.Tensor) -> torch.Tensor:
    """OWL-QN pseudo-gradient of f(w) + ||l1w * w||_1: the subgradient
    ``g + l1w·sign(w)`` where w != 0; at w == 0 the one-sided derivative
    when it is negative in either direction, else 0."""
    nonzero = g + l1w * torch.sign(w)
    lo = g - l1w  # right derivative
    hi = g + l1w  # left derivative
    zero = torch.zeros_like(g)
    at_zero = torch.where(lo > 0.0, lo, torch.where(hi < 0.0, hi, zero))
    return torch.where(w != 0.0, nonzero, at_zero)


def _two_loop(
    g: torch.Tensor, S: List[torch.Tensor], Y: List[torch.Tensor]
) -> torch.Tensor:
    """L-BFGS two-loop recursion H·g over the pairs (oldest -> newest)."""
    tiny = 1e-30
    q = g.clone()
    alphas: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for s, y in zip(reversed(S), reversed(Y)):
        rho = 1.0 / torch.clamp(torch.dot(y, s), min=tiny)
        a = rho * torch.dot(s, q)
        q = q - a * y
        alphas.append((a, rho))
    if S:
        s_r, y_r = S[-1], Y[-1]
        gamma = torch.dot(s_r, y_r) / torch.clamp(torch.dot(y_r, y_r), min=tiny)
    else:
        gamma = torch.ones((), dtype=g.dtype, device=g.device)
    r = gamma * q
    for (a, rho), s, y in zip(reversed(alphas), S, Y):
        beta = rho * torch.dot(y, r)
        r = r + s * (a - beta)
    return r


def minimize_lbfgs(
    fun: Callable[[torch.Tensor], torch.Tensor],
    w0: torch.Tensor,
    *,
    max_iter: int,
    tol: float,
    l1_weights: Optional[torch.Tensor] = None,
    history: int = 10,
    max_ls: int = 30,
) -> LbfgsResult:
    """Minimize ``fun(w) + ||l1_weights * w||_1`` from ``w0``.

    ``fun`` is a smooth scalar loss, differentiable by ``torch.autograd``.
    With ``l1_weights`` None the algorithm is plain L-BFGS; otherwise
    OWL-QN."""
    use_l1 = l1_weights is not None
    l1w = l1_weights if use_l1 else torch.zeros_like(w0)

    def full_obj_parts(w: torch.Tensor) -> Tuple[float, torch.Tensor]:
        """(L1-inclusive objective, smooth gradient), one fwd+bwd pass."""
        wv = w.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(wv)
            (g,) = torch.autograd.grad(f, wv)
        return float(f.detach() + torch.abs(l1w * w).sum()), g

    w = w0.clone()
    f, g = full_obj_parts(w)
    S: List[torch.Tensor] = []
    Y: List[torch.Tensor] = []
    c1 = 1e-4
    it = 0
    converged = False
    while it < max_iter and not converged:
        pg = _pseudo_gradient(w, g, l1w) if use_l1 else g
        d = -_two_loop(pg, S, Y)
        if use_l1:
            d = torch.where(d * pg < 0.0, d, torch.zeros_like(d))  # sign fix
            xi = torch.where(w != 0.0, torch.sign(w), -torch.sign(pg))  # orthant
        dir_deriv = float(torch.dot(pg, d))
        d_norm = float(torch.sqrt(torch.dot(d, d)))
        t = 1.0 / max(d_norm, 1.0) if not S else 1.0

        def trial_point(tv: float) -> torch.Tensor:
            w_t = w + tv * d
            if use_l1:
                w_t = torch.where(w_t * xi < 0.0, torch.zeros_like(w_t), w_t)
            return w_t

        # Armijo backtracking; each trial is one value-and-gradient pass,
        # so the accepted trial's gradient feeds the curvature update
        f_new, g_new = full_obj_parts(trial_point(t))
        n_try = 0
        while not f_new <= f + c1 * t * dir_deriv and n_try < max_ls:
            t *= 0.5
            f_new, g_new = full_obj_parts(trial_point(t))
            n_try += 1
        w_new = trial_point(t)

        s = w_new - w
        yv = g_new - g
        if float(torch.dot(s, yv)) > 1e-10:
            S.append(s)
            Y.append(yv)
            if len(S) > history:
                S.pop(0)
                Y.pop(0)
        denom = max(abs(f), abs(f_new), 1.0)
        rel_impr = (f - f_new) / denom
        converged = rel_impr <= tol or dir_deriv >= 0.0
        w, f, g = w_new, f_new, g_new
        it += 1
    return LbfgsResult(w=w, f=f, n_iter=it, converged=converged)
