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

:func:`minimize_lbfgs_host` (counterpart of ``minimize_lbfgs_host``) is the
same algorithm in float64 numpy on the host, for objectives whose every
evaluation streams the dataset through the card in chunks; its arithmetic
follows the JAX package's line by line, so the same ``value_grad`` gives
the same iterates bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class LbfgsResult(NamedTuple):
    w: Any            # (p,) solution: a tensor (minimize_lbfgs), f64 numpy (minimize_lbfgs_host)
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
    OWL-QN. The iterates, history and two-loop recursion are in ``w0``'s
    dtype (the fit's: float32, or float64 under ``float32_inputs=False``)."""
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


def minimize_lbfgs_host(
    value_grad: Callable[[np.ndarray], Tuple[float, np.ndarray]],
    w0,
    *,
    max_iter: int,
    tol: float,
    l1_weights=None,
    history: int = 10,
    max_ls: int = 30,
    checkpointer=None,
) -> LbfgsResult:
    """Host-driven L-BFGS/OWL-QN: the loop and its O(m·p) two-loop
    recursion in float64 numpy, each ``value_grad(w)`` free to make a full
    chunked pass over the data on the card. ``value_grad`` returns the
    SMOOTH ``(f, g)``; the L1 term is added here. Returns ``w`` as f64
    numpy and ``f``, ``n_iter``, ``converged`` as Python values.

    ``checkpointer`` (a ``runtime.FitCheckpointer``, or None) snapshots
    the whole carry (``w``, ``g``, the ``S``/``Y`` history, ``f`` and
    ``converged``) after each iteration, and a refit resumes from the last
    committed one, skipping the evaluations before it: the algorithm is
    deterministic given the carry, so the resumed walk takes the
    uninterrupted walk's iterates. The files are cleared at the end. The
    JAX package's fault site and preempt point are not ported (ROADMAP
    queue 1 item 7)."""
    w = np.asarray(w0, dtype=np.float64)
    p = w.shape[0]
    use_l1 = l1_weights is not None
    l1w = np.asarray(l1_weights, np.float64) if use_l1 else np.zeros((p,))

    def full_obj(wv):
        f, g = value_grad(wv)
        return float(f) + float(np.abs(l1w * wv).sum()), np.asarray(g, np.float64)

    def pseudo_grad(wv, g):
        nonzero = g + l1w * np.sign(wv)
        lo = g - l1w
        hi = g + l1w
        at_zero = np.where(lo > 0.0, lo, np.where(hi < 0.0, hi, 0.0))
        return np.where(wv != 0.0, nonzero, at_zero)

    S: list = []
    Y: list = []
    c1 = 1e-4
    it = 0
    converged = False
    resumed = checkpointer.load() if checkpointer is not None else None
    if resumed is not None:
        it, arrays, extra = resumed
        w = np.asarray(arrays["w"], np.float64)
        g = np.asarray(arrays["g"], np.float64)
        S = [np.asarray(row, np.float64) for row in arrays["S"]]
        Y = [np.asarray(row, np.float64) for row in arrays["Y"]]
        f = float(extra["f"])
        converged = bool(extra.get("converged", False))
    else:
        f, g = full_obj(w)
    while it < max_iter and not converged:
        pg = pseudo_grad(w, g) if use_l1 else g
        # two-loop recursion over the (oldest -> newest) history
        q = pg.copy()
        alphas = []
        for s, yv in reversed(list(zip(S, Y))):
            rho = 1.0 / max(float(yv @ s), 1e-30)
            a = rho * float(s @ q)
            q -= a * yv
            alphas.append((a, rho))
        if S:
            s_r, y_r = S[-1], Y[-1]
            gamma = float(s_r @ y_r) / max(float(y_r @ y_r), 1e-30)
        else:
            gamma = 1.0
        r = gamma * q
        for (a, rho), (s, yv) in zip(reversed(alphas), zip(S, Y)):
            beta = rho * float(yv @ r)
            r += s * (a - beta)
        d = -r
        if use_l1:
            d = np.where(d * pg < 0.0, d, 0.0)
            xi = np.where(w != 0.0, np.sign(w), -np.sign(pg))
        dir_deriv = float(pg @ d)

        d_norm = float(np.sqrt(d @ d))
        t = 1.0 / max(d_norm, 1.0) if not S else 1.0

        def trial(tv):
            wt = w + tv * d
            if use_l1:
                wt = np.where(wt * xi < 0.0, 0.0, wt)
            return wt

        f_t, g_t = full_obj(trial(t))
        n_try = 0
        while f_t > f + c1 * t * dir_deriv and n_try < max_ls:
            t *= 0.5
            f_t, g_t = full_obj(trial(t))
            n_try += 1
        w_new = trial(t)

        s = w_new - w
        yv = g_t - g
        if float(s @ yv) > 1e-10:
            S.append(s)
            Y.append(yv)
            if len(S) > history:
                S.pop(0)
                Y.pop(0)

        denom = max(abs(f), abs(f_t), 1.0)
        rel_impr = (f - f_t) / denom
        converged = rel_impr <= tol or dir_deriv >= 0.0
        w, f, g = w_new, f_t, g_t
        it += 1
        if checkpointer is not None:
            checkpointer.maybe_save(
                it,
                {"w": w, "g": g, "S": np.stack(S) if S else np.zeros((0, p)),
                 "Y": np.stack(Y) if Y else np.zeros((0, p))},
                {"f": f, "converged": bool(converged)},
            )
    if checkpointer is not None:
        checkpointer.clear()
    return LbfgsResult(w=w, f=float(f), n_iter=int(it), converged=bool(converged))
