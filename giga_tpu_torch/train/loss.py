"""Training losses + metrics (counterpart of giga_tpu/train/loss.py;
reference: scripts/train_giga.py:154-195).

Per-sample composite:
    loss = BCE(qual, label) + label * (rot_loss + 0.01 * width_mse) + occ_bce
with
    rot_loss  = min over the two gripper-symmetric target quats of
                (1 - |<pred, target>|)                  (train_giga.py:181-188)
    width_mse = MSE(40 * pred, 40 * target)             (train_giga.py:191-192)
    occ_bce   = mean-over-points BCE(sigmoid(occ_logits), occ)
The qual head outputs probabilities (sigmoid applied in the model), so BCE
uses torch's binary_cross_entropy convention with log clamping at -100.
"""

from __future__ import annotations

import torch


def binary_cross_entropy(pred_prob, target):
    """torch F.binary_cross_entropy (on probabilities, log clamped to -100)."""
    log_p = torch.clamp_min(torch.log(pred_prob), -100.0)
    log_1mp = torch.clamp_min(torch.log1p(-pred_prob), -100.0)
    return -(target * log_p + (1.0 - target) * log_1mp)


def bce_with_logits(logits, target):
    """Numerically stable BCE from logits."""
    return (torch.clamp_min(logits, 0) - logits * target
            + torch.log1p(torch.exp(-torch.abs(logits))))


def quat_loss(pred, target):
    """1 - |<pred, target>| per sample."""
    return 1.0 - torch.abs(torch.sum(pred * target, dim=-1))


def rot_loss(pred, rotations):
    """min over the two symmetric target quaternions; rotations (B, 2, 4)."""
    return torch.minimum(quat_loss(pred, rotations[:, 0]), quat_loss(pred, rotations[:, 1]))


def width_loss(pred, target):
    return (40.0 * pred - 40.0 * target) ** 2


def occ_loss(logits, occ):
    """(B, N) logits vs (B, N) {0,1} -> (B,) mean-over-points BCE."""
    return bce_with_logits(logits, occ).mean(dim=-1)


def giga_loss(outputs: dict, batch: dict):
    """Composite loss. outputs: model dict at the grasp point (N=1 squeezed).

    batch: label (B,), rotations (B, 2, 4), width (B,), occ (B, N).
    Returns (scalar loss, dict of per-term means).
    """
    label = batch["label"]
    loss_qual = binary_cross_entropy(outputs["qual"], label)
    loss_rot = rot_loss(outputs["rot"], batch["rotations"])
    loss_width = width_loss(outputs["width"], batch["width"])
    terms = {"loss_qual": loss_qual.mean(), "loss_rot": loss_rot.mean(),
             "loss_width": loss_width.mean()}
    loss = loss_qual + label * (loss_rot + 0.01 * loss_width)
    if "occ" in outputs:
        l_occ = occ_loss(outputs["occ"], batch["occ"])
        loss = loss + l_occ
        terms["loss_occ"] = l_occ.mean()
    loss = loss.mean()
    terms["loss_all"] = loss
    return loss, terms


def occ_only_loss(outputs: dict, batch: dict):
    """GIGA-Geo objective: occupancy BCE only (train_giga_geo.py)."""
    loss = occ_loss(outputs["occ"], batch["occ"]).mean()
    return loss, {"loss_occ": loss, "loss_all": loss}


def classification_metrics(pred_prob, label):
    """Accuracy / precision / recall of round(qual) vs label as sums.

    Returns raw counts so they can be summed across batches.
    """
    pred = torch.round(pred_prob)
    return {"tp": torch.sum(pred * label), "fp": torch.sum(pred * (1 - label)),
            "fn": torch.sum((1 - pred) * label),
            "correct": torch.sum(pred == label).to(torch.float32),
            "n": torch.full((), float(label.numel()), device=label.device)}
