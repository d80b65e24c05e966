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

:func:`minimize_lbfgs_batched` (counterpart of ``minimize_lbfgs_batched``)
runs B independent problems in one loop, each objective evaluation one
batched pass for all lanes: the gang fits of ``fitMultiple`` and the
CrossValidator. The JAX package's state layout is kept (circular
``(B, history, p)`` history buffers and a per-lane pair count), and a lane
that has converged or run out of iterations is frozen bit for bit while
the others run on. The loop is driven from the host: one read of a
``(B,)`` flag a round and one a halving round of the line search.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..runtime import counters
from ..runtime.faults import fault_site
from ..runtime.scheduler import preempt_point


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


class LbfgsBatchedResult(NamedTuple):
    w: torch.Tensor          # (B, p) per-lane solutions
    f: torch.Tensor          # (B,) final objectives (incl. L1 term)
    n_iter: torch.Tensor     # (B,) iterations each lane took
    converged: torch.Tensor  # (B,) bool


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane by lane dot products of two (B, p) tensors."""
    return (a * b).sum(dim=-1)


def _two_loop_batched(
    g: torch.Tensor, S: torch.Tensor, Y: torch.Tensor, k: torch.Tensor
) -> torch.Tensor:
    """The two-loop recursion H·g of every lane on circular buffers, the
    JAX package's ``_two_loop`` mapped over lanes: ``S``/``Y`` are
    (B, m, p), entry i of lane b is valid iff i < min(k[b], m), and lane b's
    newest pair lives at (k[b] - 1) % m. Each lane reads its pairs newest
    to oldest, then oldest to newest, as the solo recursion reads its
    list; invalid entries contribute exact zeros."""
    B, m, _ = S.shape
    tiny = 1e-30
    lanes = torch.arange(B, device=g.device)
    n_valid = torch.clamp(k, max=m)
    q = g
    alphas = torch.zeros((B, m), dtype=g.dtype, device=g.device)
    for i in range(m):
        idx = (k - 1 - i) % m
        valid = (i < n_valid).to(g.dtype)
        s, y = S[lanes, idx], Y[lanes, idx]
        rho = 1.0 / torch.clamp(_vdot(y, s), min=tiny)
        alpha = rho * _vdot(s, q) * valid
        q = q - alpha[:, None] * y
        alphas[lanes, idx] = alpha
    recent = (k - 1) % m
    s_r, y_r = S[lanes, recent], Y[lanes, recent]
    gamma = torch.where(
        k > 0, _vdot(s_r, y_r) / torch.clamp(_vdot(y_r, y_r), min=tiny), torch.ones_like(alphas[:, 0])
    )
    r = gamma[:, None] * q
    for i in range(m):
        idx = (k - n_valid + i) % m  # oldest -> newest
        valid = (i < n_valid).to(g.dtype)
        s, y = S[lanes, idx], Y[lanes, idx]
        rho = 1.0 / torch.clamp(_vdot(y, s), min=tiny)
        beta = rho * _vdot(y, r)
        r = r + s * ((alphas[lanes, idx] - beta) * valid)[:, None]
    return r


def minimize_lbfgs_batched(
    fun: Callable[[torch.Tensor], torch.Tensor],
    w0: torch.Tensor,
    *,
    max_iter: int,
    tol: torch.Tensor,
    l1_weights: Optional[torch.Tensor] = None,
    history: int = 10,
    max_ls: int = 30,
) -> LbfgsBatchedResult:
    """B independent :func:`minimize_lbfgs` problems in one loop.

    ``fun`` is the batched smooth loss ``(B, p) -> (B,)``, lane b's value a
    function of row b alone, so one backward pass with a ones cotangent
    gives every lane's gradient: one forward and backward data pass for
    all lanes. ``w0`` is (B, p), ``tol`` (B,); ``l1_weights`` (B, p), where
    given, switches the whole call to OWL-QN (its sign fix is no identity
    at l1 = 0, so plain lanes go in a call of their own).

    A lane that converges or reaches ``max_iter`` is frozen: every update
    is ``torch.where(active, new, old)``, so its ``w / f / g / S / Y / k``
    stay bit for bit however long the other lanes run. Every pass keeps
    all B lanes (a frozen lane's row is computed and discarded), so a
    lane's arithmetic never depends on how many others are still running.
    The Armijo line search is per lane: each halving round is one batched
    pass, whose values only the lanes still searching take."""
    dtype, device = w0.dtype, w0.device
    B, p = w0.shape
    use_l1 = l1_weights is not None
    l1w = l1_weights if use_l1 else torch.zeros_like(w0)
    tol = torch.as_tensor(tol, dtype=dtype, device=device)

    def full_obj_parts(W: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-lane (L1-inclusive objective, smooth gradient), one shared
        forward and backward pass."""
        Wv = W.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(Wv)
            (g,) = torch.autograd.grad(f, Wv, grad_outputs=torch.ones_like(f))
        return f.detach() + torch.abs(l1w * W).sum(dim=-1), g

    w = w0.clone()
    f, g = full_obj_parts(w)
    S = torch.zeros((B, history, p), dtype=dtype, device=device)
    Y = torch.zeros((B, history, p), dtype=dtype, device=device)
    k = torch.zeros((B,), dtype=torch.int64, device=device)
    it = torch.zeros((B,), dtype=torch.int64, device=device)
    converged = torch.zeros((B,), dtype=torch.bool, device=device)
    lanes = torch.arange(B, device=device)
    c1 = 1e-4
    while True:
        # lanes still running this round; what a frozen lane computes below
        # is discarded by the where-guards
        active = ~converged & (it < max_iter)
        if not bool(active.any()):
            break
        pg = _pseudo_gradient(w, g, l1w) if use_l1 else g
        d = -_two_loop_batched(pg, S, Y, k)
        if use_l1:
            d = torch.where(d * pg < 0.0, d, torch.zeros_like(d))  # sign fix
            xi = torch.where(w != 0.0, torch.sign(w), -torch.sign(pg))  # orthant
        dir_deriv = _vdot(pg, d)
        d_norm = torch.sqrt(_vdot(d, d))
        t = torch.where(k == 0, 1.0 / torch.clamp(d_norm, min=1.0), torch.ones_like(d_norm))

        def trial_point(tv: torch.Tensor) -> torch.Tensor:
            w_t = w + tv[:, None] * d
            if use_l1:
                w_t = torch.where(w_t * xi < 0.0, torch.zeros_like(w_t), w_t)
            return w_t

        f_t, g_t = full_obj_parts(trial_point(t))
        ok = f_t <= f + c1 * t * dir_deriv
        n_try = torch.zeros((B,), dtype=torch.int64, device=device)
        while True:
            need = active & ~ok & (n_try < max_ls)
            if not bool(need.any()):
                break
            t = torch.where(need, t * 0.5, t)
            f_n, g_n = full_obj_parts(trial_point(t))
            f_t = torch.where(need, f_n, f_t)
            g_t = torch.where(need[:, None], g_n, g_t)
            ok = torch.where(need, f_t <= f + c1 * t * dir_deriv, ok)
            n_try = n_try + need.to(torch.int64)
        w_new = trial_point(t)

        s = w_new - w
        yv = g_t - g
        store = active & (_vdot(s, yv) > 1e-10)
        idx = k % history
        S[lanes, idx] = torch.where(store[:, None], s, S[lanes, idx])
        Y[lanes, idx] = torch.where(store[:, None], yv, Y[lanes, idx])
        k = torch.where(store, k + 1, k)

        denom = torch.clamp(torch.maximum(torch.abs(f), torch.abs(f_t)), min=1.0)
        rel_impr = (f - f_t) / denom
        conv_now = (rel_impr <= tol) | (dir_deriv >= 0.0)
        # the freeze: frozen lanes keep w / f / g (and S / Y / k through
        # the store guard, which needs `active`) bit for bit
        w = torch.where(active[:, None], w_new, w)
        f = torch.where(active, f_t, f)
        g = torch.where(active[:, None], g_t, g)
        converged = torch.where(active, conv_now, converged)
        it = it + active.to(torch.int64)
    return LbfgsBatchedResult(w=w, f=f, n_iter=it, converged=converged)


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
    uninterrupted walk's iterates, and bumps ``resumed_fits`` and notes
    ``resumed_from`` (``runtime.counters``). The files are cleared at the
    end. Each iteration is an ``sgd:epoch`` fault site
    (``runtime.faults``), and after each checkpoint the loop yields to the
    fit scheduler where its quantum has run out
    (``runtime.scheduler.preempt_point``: a forced save at that iteration,
    then ``FitPreempted``)."""
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
        counters.bump("resumed_fits")
        counters.note("resumed_from", it)
    else:
        f, g = full_obj(w)
    while it < max_iter and not converged:
        fault_site("sgd:epoch")
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
            def state():
                return {"w": w, "g": g, "S": np.stack(S) if S else np.zeros((0, p)),
                        "Y": np.stack(Y) if Y else np.zeros((0, p))}

            extra = {"f": f, "converged": bool(converged)}
            checkpointer.maybe_save(it, state(), extra)
            preempt_point(checkpointer, it, state, extra)
    if checkpointer is not None:
        checkpointer.clear()
    return LbfgsResult(w=w, f=float(f), n_iter=int(it), converged=bool(converged))
