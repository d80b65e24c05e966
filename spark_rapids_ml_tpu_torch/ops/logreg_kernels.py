"""LogisticRegression kernels of the port (counterpart of
``spark_rapids_ml_tpu/ops/logreg_kernels.py`` and ``logreg_pallas.py``,
single device).

Holds kernel K3, the fused logistic loss and gradient
(``csrc/logreg_loss_grad.cu``), beside its plain PyTorch version, wrapped in
a ``torch.autograd.Function`` whose forward pass also yields the gradient,
so each L-BFGS value-and-gradient costs one read of X (the contract of the
JAX package's custom VJP). ``logreg_fit`` keeps the JAX package's
standardization-as-reparametrization, intercept handling and multinomial
intercept centring.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from . import _build
from .lbfgs import minimize_lbfgs
from .linalg import _check_cuda_f32, masked_mean, standardize_moments

_I64, _P = ctypes.c_int64, ctypes.c_void_p

# csrc/logreg_loss_grad.cu limits: rows per tile and the (rows, K) logit
# tile kept in at most 48 KB of shared memory
_LOGREG_TILE_ROWS = 64
_LOGREG_SMEM = 48 * 1024
# cap on the per-block (K, d+1) partials the second pass reduces
_LOGREG_SCRATCH = 256 << 20


def logreg_loss_grad_plain(
    X: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
    A: torch.Tensor, b: torch.Tensor, multinomial: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``(Σ m·logloss, gA (K, d), gb (K,))`` with
    logits ``X Aᵀ + b`` and residuals ``R = (p - onehot(y))·m``."""
    z = X @ A.T + b[None, :]
    if multinomial:
        yi = y.to(torch.int64)
        lse = torch.logsumexp(z, dim=1)
        onehot = torch.nn.functional.one_hot(yi, z.shape[1]).to(z.dtype)
        ll = lse - (z * onehot).sum(dim=1)
        R = (torch.softmax(z, dim=1) - onehot) * m[:, None]
    else:
        z1 = z[:, 0]
        ll = torch.nn.functional.softplus(z1) - y * z1
        R = ((torch.sigmoid(z1) - y) * m)[:, None]
    return (ll * m).sum(), R.T @ X, R.sum(dim=0)


def logreg_loss_grad(
    X: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
    A: torch.Tensor, b: torch.Tensor, multinomial: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K3: loss, ``gA`` and ``gb`` of the masked logistic data term
    in one pass over ``X`` (n, d); ``A`` (K, d), ``b`` (K,), K = 1 for the
    binomial (sigmoid) form.

    A CPU tensor goes to :func:`logreg_loss_grad_plain`; a CUDA tensor to
    the CUDA kernel, or this raises (bf16 X included: not ported yet).
    Replaces ``spark_rapids_ml_tpu/ops/logreg_pallas.py::_loss_grad_pallas``."""
    if X.device.type == "cpu":
        return logreg_loss_grad_plain(X, y, m, A, b, multinomial)
    _check_cuda_f32("logreg_loss_grad", X, y, m, A, b)
    n, d = X.shape
    K = A.shape[0]
    if y.shape != (n,) or m.shape != (n,) or A.shape[1] != d or b.shape != (K,):
        raise ValueError(
            f"logreg_loss_grad: shapes X {tuple(X.shape)}, y {tuple(y.shape)}, "
            f"m {tuple(m.shape)}, A {tuple(A.shape)}, b {tuple(b.shape)} do not agree"
        )
    if not multinomial and K != 1:
        raise ValueError("logreg_loss_grad: the binomial form takes K = 1")
    rt = min(_LOGREG_TILE_ROWS, _LOGREG_SMEM // (4 * K))
    if rt < 1:
        raise ValueError(
            f"logreg_loss_grad: K = {K} classes exceed the kernel's logit tile"
        )
    dev = X.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block = K * (d + 1)
    # small K*d (the binomial main path) takes the row-per-warp kernel,
    # whose float4 loads need 16-byte aligned rows
    variant = _build.function(
        "logreg_loss_grad", "logreg_rows_variant", [ctypes.c_int, ctypes.c_int]
    )(d, K)
    if X.data_ptr() % 16 or A.data_ptr() % 16:
        variant = 0
    if variant:
        nblocks = max(1, min(-(-max(n, 1) // 16), 4 * sms))
        rows = 0
    else:
        nblocks = max(1, min(-(-max(n, 1) // rt), 8 * sms, _LOGREG_SCRATCH // (4 * per_block)))
        rows = -(-max(n, 1) // nblocks)
        nblocks = -(-max(n, 1) // rows)
    gA = torch.empty((K, d), dtype=torch.float32, device=dev)
    gb = torch.empty((K,), dtype=torch.float32, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    part = torch.empty((nblocks, per_block), dtype=torch.float32, device=dev)
    loss_part = torch.empty((nblocks,), dtype=torch.float32, device=dev)
    fn = _build.function(
        "logreg_loss_grad", "logreg_loss_grad_launch",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _I64, ctypes.c_int, _P],
    )
    code = fn(
        X.data_ptr(), y.data_ptr(), m.data_ptr(), A.data_ptr(), b.data_ptr(),
        gA.data_ptr(), gb.data_ptr(), loss.data_ptr(), part.data_ptr(),
        loss_part.data_ptr(), n, d, K, int(multinomial), rt, nblocks, rows, variant,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    logreg_loss_grad.launches += 1
    _build.check("logreg_loss_grad", code)
    return loss[0], gA, gb


logreg_loss_grad.launches = 0


class _FusedDataLoss(torch.autograd.Function):
    """``Σ m·logloss`` as a function of ``(Aeff, beff)`` whose forward pass
    also computes the gradient (one data pass); backward scales it."""

    @staticmethod
    def forward(ctx, Aeff, beff, X, y, m, multinomial):  # type: ignore[override]
        loss, gA, gb = logreg_loss_grad(
            X, y, m, Aeff.contiguous(), beff.contiguous(), multinomial
        )
        ctx.save_for_backward(gA, gb)
        return loss

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        gA, gb = ctx.saved_tensors
        return g * gA, g * gb, None, None, None, None


def make_fused_data_loss(
    X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, multinomial: bool
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``f(Aeff, beff) -> Σ m·logloss`` whose value and gradient cost one
    data pass (kernel K3 on the card, its plain version on the CPU)."""

    def f(Aeff: torch.Tensor, beff: torch.Tensor) -> torch.Tensor:
        return _FusedDataLoss.apply(Aeff, beff, X, y, mask, multinomial)

    return f


def logreg_fit(
    X: torch.Tensor,
    mask: torch.Tensor,
    y: torch.Tensor,
    *,
    n_classes: int,
    multinomial: bool,
    fit_intercept: bool,
    standardization: bool,
    l1: float,
    l2: float,
    use_l1: bool,
    max_iter: int,
    tol: float,
    history: int = 10,
    objective_dtype: str = "float32",
) -> Dict[str, object]:
    """Fit logistic regression; returns ``coef_`` (K, d), ``intercept_``
    (K,), ``n_iter``, ``objective``. K = 1 for the binomial (sigmoid)
    form, else ``n_classes``.

    Spark objective ``(1/n)·Σ logloss + λ[(1−α)/2‖β‖₂² + α‖β‖₁]`` on the
    standardized coefficients, never on intercepts. Standardization is a
    reparametrization: the solver works in standardized-coefficient space
    and the affine map folds into the logits (``to_original``), so X is
    never copied."""
    if objective_dtype != "float32":
        raise NotImplementedError(
            f"objective_dtype={objective_dtype!r}: only float32 is ported"
        )
    dtype = X.dtype
    d = X.shape[1]
    n = mask.sum()
    yf = y.to(dtype)

    if standardization:
        mean, std, _ = standardize_moments(X, mask, ddof=1)
        inv_std = torch.where(std > 0, 1.0 / std, torch.ones_like(std))
    else:
        mean, _ = masked_mean(X, mask)
        inv_std = torch.ones((d,), dtype=dtype, device=X.device)
    # the reference skips centering when fit_intercept=False
    use_center = standardization and fit_intercept

    K = n_classes if multinomial else 1
    n_coef = K * d
    p = n_coef + (K if fit_intercept else 0)

    def unpack(wflat: torch.Tensor):
        A = wflat[:n_coef].reshape(K, d)
        b = wflat[n_coef:] if fit_intercept else torch.zeros((K,), dtype=dtype, device=X.device)
        return A, b

    def to_original(A: torch.Tensor, b: torch.Tensor):
        Aeff = A * inv_std[None, :]
        beff = b - (Aeff @ mean) if use_center else b
        return Aeff, beff

    coef_mask = torch.cat([
        torch.ones((n_coef,), dtype=dtype, device=X.device),
        torch.zeros((p - n_coef,), dtype=dtype, device=X.device),
    ])
    fused_data = make_fused_data_loss(X, yf, mask, multinomial)

    def smooth_loss(wflat: torch.Tensor) -> torch.Tensor:
        A, b = unpack(wflat)
        Aeff, beff = to_original(A, b)
        data_loss = fused_data(Aeff, beff) / n
        coefs = wflat * coef_mask  # penalty never touches intercepts
        return data_loss + 0.5 * l2 * torch.dot(coefs, coefs)

    w0 = torch.zeros((p,), dtype=dtype, device=X.device)
    res = minimize_lbfgs(
        smooth_loss,
        w0,
        max_iter=max_iter,
        tol=tol,
        l1_weights=l1 * coef_mask if use_l1 else None,
        history=history,
    )
    A, b = unpack(res.w)
    coef, intercept = to_original(A, b)
    if fit_intercept and K > 1:
        # Spark centers multinomial intercepts
        intercept = intercept - intercept.mean()
    return {
        "coef_": coef,
        "intercept_": intercept,
        "n_iter": res.n_iter,
        "objective": res.f,
    }


def logreg_predict(
    Xb: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor, *, multinomial: bool
):
    """Batch inference -> (prediction, probability, rawPrediction); the
    binomial rawPrediction follows Spark's [-m, m] convention."""
    scores = Xb @ coef.T + intercept[None, :]
    if multinomial:
        raw = scores
        prob = torch.softmax(scores, dim=1)
        pred = torch.argmax(scores, dim=1).to(Xb.dtype)
    else:
        z = scores[:, 0]
        raw = torch.stack([-z, z], dim=1)
        p1 = torch.sigmoid(z)
        prob = torch.stack([1.0 - p1, p1], dim=1)
        pred = (p1 > 0.5).to(Xb.dtype)
    return pred, prob, raw
