"""Plain PyTorch versions of the port's kernels: the CPU path and the
reference each kernel is held against on the card."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fused_conv_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, *, stride: int = 1, padding: int = 1,
                   relu: bool = True,
                   residual: torch.Tensor | None = None) -> torch.Tensor:
    """CONV + BN(folded scale/shift) [+ADD] [+RELU] — the paper's fused
    PIMcore op.  x: (B, H, W, Cin), w: (kh, kw, Cin, Cout); f32 inside,
    returned in ``x.dtype``."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1),
                 stride=stride, padding=padding).permute(0, 2, 3, 1)
    y = y * scale.float() + shift.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


NEG_INF = -1e30


def _visible(S: int, T: int, causal: bool, window: int,
             device) -> torch.Tensor:
    """(S, T): query i sees key j when j <= i (causal, top-left) and
    j > i - window (window > 0)."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, stats: bool = False):
    """q: (BH, S, D); k/v: (BKV, T, D), BH = BKV·group — the flash kernel's
    layout.  f32 inside, masked logits -1e30, returned in ``q.dtype``.  The
    causal mask is top-left: query i sees keys ≤ i, also when S ≠ T.  With
    ``stats`` it returns (out, lse, None), as the kernel does: lse is each
    row's log-sum-exp of its masked logits, f32 (BH, S); the plain version
    keeps no lo part of O."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    group = BH // BKV
    kf = k.repeat_interleave(group, dim=0).float()
    vf = v.repeat_interleave(group, dim=0).float()
    s = torch.einsum("hsd,htd->hst", q.float(), kf) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = _visible(S, T, causal, window, q.device)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("hst,htd->hsd", p, vf).to(q.dtype)
    if stats:
        return out, torch.logsumexp(s, dim=-1), None
    return out


def attention_ref_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, *, causal: bool = True,
                       window: int = 0, softcap: float = 0.0
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``attention_ref`` (the arithmetic of the models'
    ``attention_scores``) with respect to q, k and v, for the output
    gradient ``dout`` (BH, S, D): recomputed in f32 from the inputs, dk and
    dv summed over each KV head's query group, returned in the inputs'
    dtypes.  The probabilities are recomputed from q, k and v; the
    backward kernels recompute them from the forward's saved log-sum-exp,
    this plain version from the logits themselves."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    G = BH // BKV
    qf = q.float().reshape(BKV, G, S, D)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(BKV, G, S, D)
    s = torch.einsum("bgsd,btd->bgst", qf, kf) / math.sqrt(D)
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = _visible(S, T, causal, window, q.device)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    del s
    dv = torch.einsum("bgst,bgsd->btd", p, do)
    # softmax backward, p ∘ (dp - rowsum(p ∘ dp)), in dp's storage
    ds = torch.einsum("bgsd,btd->bgst", do, vf)
    ds.sub_((p * ds).sum(dim=-1, keepdim=True)).mul_(p)
    del p
    if softcap:
        ds.mul_(t.square_().neg_().add_(1.0))             # tanh backward
        del t
    ds.div_(math.sqrt(D))
    dq = torch.einsum("bgst,btd->bgsd", ds, kf).reshape(BH, S, D)
    dk = torch.einsum("bgst,bgsd->btd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mamba_scan_ref(dtx: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor) -> torch.Tensor:
    """The SSD recurrence, one step at a time in f32 (f64 for f64 inputs):
    ``S_t = e^{a_t}·S_{t-1} + dtx_t ⊗ B_t``, ``y_t = S_t·C_t`` per (batch,
    head), with the (P, N) state starting at 0.  dtx: (b, S, H, P); a_log:
    (b, S, H); B/C: (b, S, N), shared by all heads.  Returns y: (b, S, H,
    P) in that dtype.  Each step makes a new state and nothing is written
    in place, so autograd differentiates it."""
    b, S, H, P = dtx.shape
    N = B.shape[-1]
    dt = torch.promote_types(dtx.dtype, torch.float32)
    dtx, B, C = dtx.to(dt), B.to(dt), C.to(dt)
    decay = a_log.to(dt).exp()
    state = torch.zeros((b, H, P, N), dtype=dt, device=dtx.device)
    ys = []
    for t in range(S):
        state = torch.addcmul(state * decay[:, t, :, None, None],
                              dtx[:, t, :, :, None], B[:, t, None, None, :])
        ys.append((state @ C[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1)


MLSTM_M0 = -1e30   # the stabiliser before the first step, as in JAX


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """The stabilised mLSTM recurrence, one step at a time in f32 (f64 for
    f64 inputs), in the order of the JAX oracle: per (batch, head), with log f = logσ(f_pre),

        m_t = max(log f_t + m_{t-1}, i_t)
        i_s = exp(i_t - m_t),  f_s = exp(log f_t + m_{t-1} - m_t)
        C_t = f_s·C_{t-1} + i_s·v_t k_tᵀ,  n_t = f_s·n_{t-1} + i_s·k_t
        h_t = C_t q_t / max(|n_t·q_t|, 1)

    with C and n starting at 0 and m at -1e30.  q, k, v: (b, S, H, P);
    i_pre, f_pre: (b, S, H).  Returns h: (b, S, H, P) in that dtype.
    Nothing is written in place, so autograd differentiates it."""
    b, S, H, P = q.shape
    dt = torch.promote_types(q.dtype, torch.float32)
    q, k, v, i_pre = q.to(dt), k.to(dt), v.to(dt), i_pre.to(dt)
    log_f = F.logsigmoid(f_pre.to(dt))
    C = torch.zeros((b, H, P, P), dtype=dt, device=q.device)
    n = torch.zeros((b, H, P), dtype=dt, device=q.device)
    m = torch.full((b, H), MLSTM_M0, dtype=dt, device=q.device)
    h = []
    for t in range(S):
        lf, it = log_f[:, t], i_pre[:, t]
        m_new = torch.maximum(lf + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(lf + m - m_new)
        C = f_s[..., None, None] * C \
            + i_s[..., None, None] * (v[:, t, :, :, None] * k[:, t, :, None, :])
        n = f_s[..., None] * n + i_s[..., None] * k[:, t]
        num = (C @ q[:, t, :, :, None])[..., 0]
        den = (n * q[:, t]).sum(-1).abs().clamp_min(1.0)
        h.append(num / den[..., None])
        m = m_new
    return torch.stack(h, dim=1)
