"""GAN training losses (counterpart of audiolab_tpu/train/losses.py;
reference: modules/rvc/infer/lib/train/losses.py and train.py:588-617 —
LS-GAN adversarial, feature matching, mel L1 x45, KL)."""

from __future__ import annotations

import torch


def discriminator_loss(real_outs, fake_outs):
    """LS-GAN: (1-D(y))² + D(ŷ)²."""
    loss = 0.0
    for r, f in zip(real_outs, fake_outs):
        loss = loss + torch.mean((1.0 - r) ** 2) + torch.mean(f ** 2)
    return loss


def generator_adv_loss(fake_outs):
    """LS-GAN generator: (1-D(ŷ))²."""
    loss = 0.0
    for f in fake_outs:
        loss = loss + torch.mean((1.0 - f) ** 2)
    return loss


def feature_matching_loss(real_fmaps, fake_fmaps):
    loss = 0.0
    for rfs, ffs in zip(real_fmaps, fake_fmaps):
        for r, f in zip(rfs, ffs):
            loss = loss + torch.mean(torch.abs(r.float() - f))
    return loss * 2.0


def kl_terms(z_p, logs_q, m_p, logs_p, z_mask):
    """The masked KL sum and the mask's sum, whose ratio is
    :func:`kl_loss` (a data-parallel step reduces each over the ranks)."""
    z_p = z_p.float()
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask), torch.sum(z_mask)


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask):
    """KL(q||p) between the posterior and the prior through the flow; the
    mask broadcasts over the channel axis of its layout."""
    num, den = kl_terms(z_p, logs_q, m_p, logs_p, z_mask)
    return num / den


def mel_l1_loss(mel_real, mel_fake, c_mel: float = 45.0):
    return c_mel * torch.mean(torch.abs(mel_real - mel_fake))
