"""Structured and sampled losses (counterpart of
``paddle_tpu/fluid/ops/structured_loss_ops.py``): CTC (warpctc), the
linear-chain CRF and its Viterbi decoding, NCE and the hierarchical
sigmoid, on torch tensors.

The dynamic programmes (the CTC alpha recursion, the CRF's forward
recursion, Viterbi) run step by step over time in the log domain, as
the reference's scans do; their gradients come from autograd through
the steps (the auto grad op), which is what the reference's vjp of its
scan gives. Lengths are dense ``Length`` tensors.

NCE draws its negative classes from the op's generator; the cost as a
function of given samples is :func:`nce_cost`, which the tests hold
against the reference's op on the samples it drew (jax.random cannot
be replayed).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register
from .common import x

_NEG = -1e30


# ---------------------------------------------------------------------------
# CTC (warpctc)
# ---------------------------------------------------------------------------

def _lse(a, b):
    """log(exp a + exp b) with _NEG as log 0."""
    m = torch.maximum(a, b)
    safe = torch.clamp(m, min=_NEG)
    return torch.where((a <= _NEG) & (b <= _NEG), torch.full_like(a, _NEG),
                       safe + torch.log(torch.exp(a - safe)
                                        + torch.exp(b - safe)))


def _ctc_loss_batch(logp, labels, logit_len, label_len, blank):
    """logp: [T, B, C] log-softmax; labels: [B, L]; returns [B] negative
    log likelihood: the alpha recursion over the extended labels
    [blank, l1, blank, l2, ..., blank] (S = 2L + 1), frozen past each
    sample's input length."""
    T, B, C = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logp.device
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.long()
    skip_ok = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                         ext[:, 2:] != ext[:, :-2]], 1)
    neg = torch.full((B, S), _NEG, dtype=torch.float32, device=dev)
    first = torch.gather(logp[0], 1, ext)
    pos = torch.arange(S, device=dev)[None, :]
    alpha = torch.where((pos == 0) | ((pos == 1) & (L > 0)), first, neg)
    pad1 = torch.full((B, 1), _NEG, dtype=torch.float32, device=dev)
    pad2 = torch.full((B, 2), _NEG, dtype=torch.float32, device=dev)
    for t in range(1, T):
        from_prev = torch.cat([pad1, alpha[:, :-1]], 1)
        from_skip = torch.where(skip_ok, torch.cat([pad2, alpha[:, :-2]], 1),
                                neg)
        a = _lse(_lse(alpha, from_prev), from_skip) \
            + torch.gather(logp[t], 1, ext)
        alpha = torch.where((t < logit_len)[:, None], a, alpha)
    send = 2 * label_len.long()
    a_last = torch.gather(alpha, 1, send[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(send - 1, min=0)[:, None])[:, 0]
    a_prev = torch.where(label_len > 0, a_prev, torch.full_like(a_prev, _NEG))
    return -_lse(a_last, a_prev)


def _warpctc_infer(op):
    lv = op.invar("LogitsLength")
    if lv is not None and lv.shape:
        b = lv.shape[0]
        for name in op.output("Loss"):
            op.block.create_var(name=name, shape=(b, 1), dtype="float32")


@register("warpctc", infer_shape=_warpctc_infer,
          no_grad_slots=("Label", "LogitsLength", "LabelLength"),
          no_grad_out_slots=("WarpCTCGrad",),
          attrs={"blank": 0, "norm_by_times": False})
def _warpctc(ctx, ins, attrs):
    """Padded-dense CTC: Logits [B, T, C] raw (softmax inside, as
    warp-ctc's), Label [B, L], LogitsLength and LabelLength [B].
    norm_by_times divides the gradient (not the loss) by the input
    length, as warp-ctc does."""
    logits = x(ins, "Logits").float()
    labels = x(ins, "Label")
    llen = x(ins, "LogitsLength").reshape(-1).long()
    tlen = x(ins, "LabelLength").reshape(-1).long()
    logp = torch.log_softmax(logits, -1).transpose(0, 1)
    nll = _ctc_loss_batch(logp, labels, llen, tlen, attrs["blank"])
    if attrs.get("norm_by_times"):
        scaled = nll / torch.clamp(llen.float(), min=1.0)
        nll = nll.detach() + scaled - scaled.detach()
    return {"Loss": [nll[:, None]],
            "WarpCTCGrad": [torch.zeros(1, device=logits.device)]}


# ---------------------------------------------------------------------------
# linear-chain CRF
# ---------------------------------------------------------------------------

def _crf_unpack(trans):
    """Paddle's transition layout [num_tags+2, num_tags]: row 0 the
    start weights, row 1 the stop weights, rows 2.. the [from, to]
    matrix."""
    return trans[0], trans[1], trans[2:]


def _lengths(ins, em):
    length = x(ins, "Length")
    if length is None:
        return torch.full((em.shape[0],), em.shape[1], dtype=torch.int64,
                          device=em.device)
    return length.reshape(-1).long()


def _crf_ll_infer(op):
    ev = op.invar("Emission")
    if ev is not None and ev.shape:
        b = ev.shape[0]
        for name in op.output("LogLikelihood"):
            op.block.create_var(name=name, shape=(b, 1), dtype="float32")


@register("linear_chain_crf", infer_shape=_crf_ll_infer,
          no_grad_slots=("Label", "Length"),
          no_grad_out_slots=("Alpha", "EmissionExps", "TransitionExps"),
          attrs={})
def _linear_chain_crf(ctx, ins, attrs):
    """Emission [B, T, N] + Label [B, T] + Length [B] -> LogLikelihood
    [B, 1]: the gold path's score less the log partition function (the
    forward recursion in the log domain). The gradient is autograd's,
    which is the marginal expectation the reference's hand-written
    backward computes."""
    em = x(ins, "Emission").float()
    lab = x(ins, "Label").long()
    if lab.dim() == 3:
        lab = lab[..., 0]
    B, T, N = em.shape
    length = _lengths(ins, em)
    start_w, stop_w, trans = _crf_unpack(x(ins, "Transition").float())

    a = start_w[None, :] + em[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(a[:, :, None] + trans[None], 1) + em[:, t]
        a = torch.where((t < length)[:, None], nxt, a)
    logz = torch.logsumexp(a + stop_w[None, :], 1)

    mask = (torch.arange(T, device=em.device)[None, :]
            < length[:, None]).float()
    em_gold = torch.gather(em, 2, lab[:, :, None])[:, :, 0]
    gold = (em_gold * mask).sum(1) + start_w[lab[:, 0]]
    last = torch.gather(lab, 1, (length - 1)[:, None])[:, 0]
    gold = gold + stop_w[last]
    pair = trans[lab[:, :-1], lab[:, 1:]]
    gold = gold + (pair * mask[:, 1:]).sum(1)
    z1 = torch.zeros(1, device=em.device)
    return {"LogLikelihood": [(gold - logz)[:, None]], "Alpha": [a],
            "EmissionExps": [z1], "TransitionExps": [z1]}


def _crf_decode_infer(op):
    ev = op.invar("Emission")
    if ev is not None and ev.shape:
        for name in op.output("ViterbiPath"):
            op.block.create_var(name=name, shape=ev.shape[:2],
                                dtype="int64")


@register("crf_decoding", grad=None, infer_shape=_crf_decode_infer,
          no_grad_slots=("Emission", "Transition", "Label", "Length"))
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decoding: the forward pass keeps back-pointers (the first
    best on a tie), the backward pass reads the best path; positions
    past Length are 0."""
    em = x(ins, "Emission").float()
    B, T, N = em.shape
    length = _lengths(ins, em)
    start_w, stop_w, trans = _crf_unpack(x(ins, "Transition").float())

    v = start_w[None, :] + em[:, 0]
    bps = []
    for t in range(1, T):
        scores = v[:, :, None] + trans[None]
        best, bp = scores.amax(1), scores.argmax(1)
        live = (t < length)[:, None]
        v = torch.where(live, best + em[:, t], v)
        bps.append(torch.where(live, bp, torch.full_like(bp, -1)))
    tag = torch.argmax(v + stop_w[None, :], 1)
    path = [tag]
    for t in range(T - 2, -1, -1):
        prev = torch.gather(bps[t], 1, tag[:, None])[:, 0]
        tag = torch.where(t + 1 < length, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], 1)
    path = torch.where(torch.arange(T, device=em.device)[None, :]
                       < length[:, None], path, torch.zeros_like(path))
    return {"ViterbiPath": [path.long()]}


# ---------------------------------------------------------------------------
# NCE
# ---------------------------------------------------------------------------

def _nce_infer(op):
    iv = op.invar("Input")
    if iv is not None and iv.shape:
        for name in op.output("Cost"):
            op.block.create_var(name=name, shape=(iv.shape[0], 1),
                                dtype="float32")


def nce_cost(inp, lab, w, b, neg, num_classes, sampler=0):
    """NCE's cost [B] and the negatives' scores [B, k] for given negative
    classes `neg` [B, k]: the binary logistic discrimination of the true
    class against the negatives, each logit less log(k q(y)) with q the
    sampler's probability (uniform 1 / num_classes; log-uniform
    log1p(1 / (y + 1)) / log(num_classes + 1))."""
    k = neg.shape[1]
    neg = neg.long()
    lab = lab.reshape(-1).long()
    if sampler == 1:
        logq = torch.log(torch.log1p(1.0 / (neg + 1.0))
                         / math.log(num_classes + 1))
        logq_pos = torch.log(torch.log1p(1.0 / (lab + 1.0))
                             / math.log(num_classes + 1))
    else:
        logq = torch.full(neg.shape, -math.log(num_classes),
                          device=inp.device)
        logq_pos = torch.full(lab.shape, -math.log(num_classes),
                              device=inp.device)

    def score(cls):
        s = torch.einsum("bkd,bd->bk", w[cls], inp)
        return s if b is None else s + b.reshape(-1)[cls]

    s_pos = score(lab[:, None])[:, 0]
    s_neg = score(neg)
    l_pos = s_pos - (math.log(k) + logq_pos)
    l_neg = s_neg - (math.log(k) + logq)
    return F.softplus(-l_pos) + F.softplus(l_neg).sum(1), s_neg


@register("nce", infer_shape=_nce_infer, stochastic=True,
          no_grad_slots=("Label", "SampleWeight"),
          no_grad_out_slots=("SampleLogits", "SampleLabels"),
          attrs={"num_total_classes": -1, "num_neg_samples": 10,
                 "sampler": 0, "seed": 0, "is_sparse": False})
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation: `num_neg_samples` classes a row
    drawn from the uniform (sampler 0) or log-uniform (1) noise
    distribution with the op's generator, then :func:`nce_cost`."""
    inp = x(ins, "Input").float()
    lab = x(ins, "Label")
    w = x(ins, "Weight").float()
    b = x(ins, "Bias")
    B = inp.shape[0]
    num_classes = attrs["num_total_classes"]
    if num_classes <= 0:
        num_classes = w.shape[0]
    k = attrs["num_neg_samples"]
    gen = ctx.generator(attrs)
    if attrs.get("sampler", 0) == 1:
        u = torch.rand((B, k), generator=gen, device=inp.device)
        neg = (torch.exp(u * math.log(num_classes + 1)) - 1.0).long()
        neg = torch.clamp(neg, 0, num_classes - 1)
    else:
        neg = torch.randint(0, num_classes, (B, k), generator=gen,
                            device=inp.device)
    cost, s_neg = nce_cost(inp, lab, w, b, neg, num_classes,
                           attrs.get("sampler", 0))
    return {"Cost": [cost[:, None]], "SampleLogits": [s_neg],
            "SampleLabels": [neg]}


# ---------------------------------------------------------------------------
# hierarchical sigmoid (complete binary tree)
# ---------------------------------------------------------------------------

def _hsig_paths(num_classes: int):
    """Heap paths of the default complete binary tree: class c is heap
    node c + num_classes; its internal node at depth d is
    (c + num_classes) >> (depth - d), the code bit the next bit down.
    Returns (node_ids, codes, mask), numpy [num_classes, max_depth]."""
    max_depth = int(math.floor(math.log2(num_classes))) + 1
    ids = np.zeros((num_classes, max_depth), np.int64)
    codes = np.zeros((num_classes, max_depth), np.float32)
    mask = np.zeros((num_classes, max_depth), np.float32)
    for c in range(num_classes):
        n = c + num_classes
        depth = n.bit_length() - 1
        for d in range(depth):
            node = n >> (depth - d)
            ids[c, d] = node - 1
            codes[c, d] = float((n >> (depth - d - 1)) & 1)
            mask[c, d] = 1.0
    return ids, codes, mask


def _hsig_infer(op):
    iv = op.invar("X")
    if iv is not None and iv.shape:
        for name in op.output("Out"):
            op.block.create_var(name=name, shape=(iv.shape[0], 1),
                                dtype="float32")


@register("hierarchical_sigmoid", infer_shape=_hsig_infer,
          no_grad_slots=("Label",),
          no_grad_out_slots=("PreOut", "W_Out"),
          attrs={"num_classes": 2, "is_sparse": False})
def _hierarchical_sigmoid(ctx, ins, attrs):
    """cost = the sum over the label's root path of
    softplus((1 - 2 code) (x . w_node + b_node))."""
    inp = x(ins, "X").float()
    lab = x(ins, "Label").reshape(-1).long()
    w = x(ins, "W").float()
    b = x(ins, "Bias")
    dev = inp.device
    ids_np, codes_np, mask_np = _hsig_paths(attrs["num_classes"])
    ids = torch.as_tensor(ids_np, device=dev)[lab]
    codes = torch.as_tensor(codes_np, device=dev)[lab]
    mask = torch.as_tensor(mask_np, device=dev)[lab]
    pre = torch.einsum("bkd,bd->bk", w[ids], inp)
    if b is not None:
        pre = pre + b.reshape(-1)[ids]
    cost = (F.softplus((1.0 - 2.0 * codes) * pre) * mask).sum(1)
    return {"Out": [cost[:, None]], "PreOut": [pre],
            "W_Out": [torch.zeros(1, device=dev)]}
