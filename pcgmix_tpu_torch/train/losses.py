"""Losses: soft-target cross-entropy and SELC (self-ensemble label
correction) (counterpart: ``pcgmix_tpu/train/losses.py``; reference
train_model.py:45-80).

The SELC soft-label table lives on the device; :func:`selc_update` updates
the batch's rows in place with ``index_copy_``, as the reference mutates
its CUDA buffer in the forward.  Under data parallelism every rank holds
the whole table and :func:`selc_share_rows` keeps the replicas equal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def soft_target_ce(logits: torch.Tensor, target_ohe: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy against (possibly soft) one-hot targets, in fp32."""
    logp = F.log_softmax(logits.float(), dim=1)
    return -(logp * target_ohe.float()).sum(dim=1).mean()


def selc_update(
    soft_labels: torch.Tensor,
    logits: torch.Tensor,
    target_ohe: torch.Tensor,
    indices: torch.Tensor,
    epoch: int,
    es: int,
    momentum: float = 0.9,
) -> torch.Tensor:
    """SELC loss; updates ``soft_labels`` in place after epoch ``es``.

    Up to epoch ``es`` (inclusive) the loss is plain CE on the targets and
    the table is untouched.  After it, the batch's table rows are
    EMA-updated with the detached predictions and the loss is CE against
    the updated rows.
    """
    if epoch <= es:
        return soft_target_ce(logits, target_ohe)
    logits = logits.float()
    indices = indices.long()
    pred = F.softmax(logits.detach(), dim=1)
    rows = soft_labels.index_select(0, indices)
    new_rows = momentum * rows + (1.0 - momentum) * pred
    soft_labels.index_copy_(0, indices, new_rows)
    logp = F.log_softmax(logits, dim=1)
    return -(logp * new_rows).sum(dim=1).mean()


def selc_share_rows(soft_labels: torch.Tensor, indices: torch.Tensor, gather) -> None:
    """Keep the table replicated under data parallelism: after
    :func:`selc_update` wrote this rank's rows, write every rank's updated
    rows into every replica.  ``gather`` concatenates a tensor over the
    ranks; the batch's indices are globally unique, so replicas agree."""
    indices = indices.long()
    rows = soft_labels.index_select(0, indices)
    soft_labels.index_copy_(0, gather(indices), gather(rows))


def init_selc_table(labels, num_classes: int, device=None) -> torch.Tensor:
    """One-hot initialization of the soft-label table."""
    labels = torch.as_tensor(labels, dtype=torch.int64, device=device)
    return F.one_hot(labels, num_classes).float()
