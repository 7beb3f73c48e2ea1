"""DAMSM and GAN losses of AttnGAN++ in PyTorch (mirrors
tise_tpu/models/attngan_pp/losses.py; reference: AttnGAN++/miscc/losses.py).

``words_loss`` is batched over the whole (image x caption) grid with length
masks, as in the JAX package, instead of the reference's loop of one
``func_attention`` a caption: its [B, B, S, T] attention is 94.7 MB in f32
at batch 64, 289 regions and 20 words.  Every BCE takes logits (the
reference's Sigmoid + BCELoss, the same values).  Masks use ``NEG_INF =
-1e9``, not -inf.

Across the processes of a group that shard the batch (``group`` not
``None``; ``trainer.make_sharded_train_step``), the DAMSM losses take this
process's images against the GLOBAL batch's captions, gather the score rows
of every process into the global [B, B] matrix, and compute this process's
rows of the image-to-caption loss and its columns of the caption-to-image
loss, averaged over its own b: the mean over processes is the global loss,
and no gradient is counted twice (``parallel.gather_rows`` sums the
gradients the processes compute for a process's rows).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tise_tpu_torch.parallel import gather_rows, group_rank

NEG_INF = -1e9


def _safe_norm(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a finite gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


class DamsmWeights(NamedTuple):
    """Smoothing constants (miscc/config.py:41-47)."""

    gamma1: float = 5.0
    gamma2: float = 5.0
    gamma3: float = 10.0
    lam: float = 1.0  # TRAIN.SMOOTH.LAMBDA


def class_mask(class_ids: Optional[torch.Tensor], batch: int) -> Optional[torch.Tensor]:
    """mask[i, j] True where j is a same-class distractor of i (losses.py:22-32)."""
    if class_ids is None:
        return None
    same = class_ids[:, None] == class_ids[None, :]
    return same & ~torch.eye(batch, dtype=torch.bool, device=class_ids.device)


def own_rows(local: int, group) -> slice:
    """The global rows of this process's ``local`` rows (all of them for
    ``group`` None)."""
    r = group_rank(group)
    return slice(r * local, (r + 1) * local)


def _sym_ce(scores: torch.Tensor, mask: Optional[torch.Tensor], rows: slice) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy with diagonal labels in both directions, same-class
    pairs masked out (losses.py:49-57), over the ``rows`` of the scores and
    the same columns."""
    if mask is not None:
        scores = scores.masked_fill(mask, NEG_INF)
    labels = torch.arange(scores.shape[0], device=scores.device)[rows]
    return F.cross_entropy(scores[rows], labels), F.cross_entropy(scores.t()[rows], labels)


def sent_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor, class_ids: Optional[torch.Tensor],
              w: DamsmWeights = DamsmWeights(), eps: float = 1e-8, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sentence-level DAMSM loss (losses.py:19-57): gamma3-scaled cosines,
    cross-entropy in both directions.  Under ``group``, ``cnn_code`` is this
    process's rows and ``rnn_code``, ``class_ids`` the global batch's."""
    num = cnn_code @ rnn_code.t()
    denom = _safe_norm(cnn_code, 1)[:, None] * _safe_norm(rnn_code, 1)
    scores = gather_rows(num / denom.clamp_min(eps) * w.gamma3, group)
    return _sym_ce(scores, class_mask(class_ids, scores.shape[0]), own_rows(cnn_code.shape[0], group))


def words_loss(img_features: torch.Tensor, words_emb: torch.Tensor, cap_lens: torch.Tensor,
               class_ids: Optional[torch.Tensor], w: DamsmWeights = DamsmWeights(), eps: float = 1e-8,
               group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Word-level DAMSM loss over the whole grid (losses.py:60-129).

    img_features [B, 17, 17, nef] (NHWC regions), words_emb [B, nef, T],
    cap_lens [B] -> (loss0, loss1, the i == j attention maps [B, T, 17, 17]).
    Under ``group``, ``img_features`` is this process's b rows and the
    attention maps are theirs; the captions are the global batch's."""
    b, ih, iw, nef = img_features.shape
    t = words_emb.shape[2]
    context = img_features.reshape(b, ih * iw, nef)  # [B, S, nef]
    valid = torch.arange(t, device=cap_lens.device)[None, :] < cap_lens[:, None]  # [B, T]
    # attn0[i, j, s, t] = <context[i, s], words[j, :, t]>
    attn0 = torch.einsum("isn,jnt->ijst", context, words_emb)
    attn0 = attn0.masked_fill(~valid[None, :, None, :], NEG_INF)
    a = torch.softmax(attn0, dim=3)  # over words (func_attention Eq. 8)
    a = torch.softmax(a * w.gamma1, dim=2)  # over regions (Eq. 9)
    wei = torch.einsum("isn,ijst->ijnt", context, a)  # the regions read back per word
    num = torch.einsum("jnt,ijnt->ijt", words_emb, wei)
    denom = _safe_norm(words_emb, 1)[None, :, :] * _safe_norm(wei, 2)
    row_sim = num / denom.clamp_min(eps)  # [B_img, B_cap, T]
    # Eq. 10: log of the sum over valid words of exp(gamma2 * sim)
    expd = torch.where(valid[None, :, :], torch.exp(row_sim * w.gamma2), torch.zeros((), device=row_sim.device))
    similarities = gather_rows(torch.log(expd.sum(dim=2).clamp_min(eps)) * w.gamma3, group)  # [B_img, B_cap]
    rows = own_rows(b, group)
    loss0, loss1 = _sym_ce(similarities, class_mask(class_ids, similarities.shape[0]), rows)
    diag = torch.diagonal(a, offset=rows.start, dim1=0, dim2=1).permute(2, 1, 0).reshape(b, t, ih, iw)
    return loss0, loss1, diag


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 mean(1 + logvar - mu^2 - exp(logvar)) (losses.py:242-246)."""
    return -0.5 * torch.mean(1 + logvar - mu * mu - torch.exp(logvar))


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


class DLossParts(NamedTuple):
    cond_real: torch.Tensor
    cond_fake: torch.Tensor
    cond_wrong: torch.Tensor
    uncond_real: torch.Tensor
    uncond_fake: torch.Tensor
    total: torch.Tensor


def discriminator_loss(real_cond: torch.Tensor, real_uncond: Optional[torch.Tensor], fake_cond: torch.Tensor,
                       fake_uncond: Optional[torch.Tensor], wrong_cond: torch.Tensor,
                       wrong_weight: float = 1.0) -> DLossParts:
    """The reference's weighting (losses.py:133-157): with the uncond head
    (real + cond_real)/2 + (fake + cond_fake + cond_wrong)/3, without it
    cond_real + (cond_fake + cond_wrong)/2.  ``wrong_cond`` are the logits
    of real features against shifted conditions (real[:B-1] with
    sentences[1:], losses.py:146-148); their mean is scaled by
    ``wrong_weight`` (a shard's share of the B - 1 pairs, times the number
    of processes), and a shard without such a pair adds 0."""
    cond_real, cond_fake = _bce(real_cond, 1.0), _bce(fake_cond, 0.0)
    cond_wrong = _bce(wrong_cond, 0.0) * wrong_weight if wrong_cond.numel() else wrong_cond.sum()
    if real_uncond is not None:
        uncond_real, uncond_fake = _bce(real_uncond, 1.0), _bce(fake_uncond, 0.0)
        total = (uncond_real + cond_real) / 2.0 + (uncond_fake + cond_fake + cond_wrong) / 3.0
    else:
        uncond_real = uncond_fake = torch.zeros((), device=real_cond.device)
        total = cond_real + (cond_fake + cond_wrong) / 2.0
    return DLossParts(cond_real, cond_fake, cond_wrong, uncond_real, uncond_fake, total)


def generator_adv_loss(cond: torch.Tensor, uncond: Optional[torch.Tensor]) -> torch.Tensor:
    """The G adversarial term of one scale (losses.py:197-206)."""
    g = _bce(cond, 1.0)
    if uncond is not None:
        g = g + _bce(uncond, 1.0)
    return g


def generator_damsm_loss(region_features: torch.Tensor, cnn_code: torch.Tensor, words_embs: torch.Tensor,
                         sent_emb: torch.Tensor, cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor],
                         w: DamsmWeights = DamsmWeights(), group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DAMSM terms at the finest scale (losses.py:218-230): (w_loss,
    s_loss), each scaled by lambda.  The caller passes f32 features: the
    loss runs in f32 under a bf16 encoder too.  Under ``group`` the image
    features are this process's rows, the text the global batch's."""
    w0, w1, _ = words_loss(region_features, words_embs, cap_lens, class_ids, w, group=group)
    s0, s1 = sent_loss(cnn_code, sent_emb, class_ids, w, group=group)
    return (w0 + w1) * w.lam, (s0 + s1) * w.lam
