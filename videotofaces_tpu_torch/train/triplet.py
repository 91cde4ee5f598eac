"""Triplet-loss fine-tuning for face encoders (counterpart of
videotofaces_tpu/train/triplet.py): batch-hard online mining as masked
matrix ops over the in-batch distance matrix, optionally widened by a
cross-batch memory bank of recent embeddings (XBM-style: the bank's
entries are stale and enter without gradient, ``bank_valid`` masks its
unfilled capacity). Embeddings are L2-normalized inside the loss.

Images are NCHW float32 here. Each step runs under ``config.model_call()``.
No mesh: the sharded steps are not ported yet.
"""

import numpy as np
import torch

from .. import config
from ..utils.weights import facenet_from_jax, facenet_to_jax
from .optim import AdamW, leaves, refuse_mesh, run_epochs, run_step
from .trainer import create_train_state  # noqa: F401 — one definition, shared


def pairwise_sq_dists(emb):
    """[B, D] -> [B, B] squared L2 distances (clamped at 0 for fp safety)."""
    g = emb @ emb.T
    sq = torch.sum(emb * emb, dim=1)
    return torch.clamp(sq[:, None] - 2.0 * g + sq[None, :], min=0.0)


def _hardest_positive(d, labels):
    """(d_ap [B], pos_mask, neg_mask) of the in-batch distances ``d``."""
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(d.shape[0], dtype=torch.bool, device=d.device)
    pos_mask = same & ~eye
    d_ap = torch.where(pos_mask, d, -torch.inf).amax(dim=1)
    return d_ap, pos_mask, ~same


def batch_hard_mining(emb, labels):
    """Hardest positive and hardest negative squared distance per anchor:
    (d_ap [B], d_an [B], valid [B]); ``valid`` marks anchors with at least
    one positive (another sample of the same label) and one negative in the
    batch, and both distances are 0 elsewhere."""
    d = pairwise_sq_dists(emb)
    d_ap, pos_mask, neg_mask = _hardest_positive(d, labels)
    d_an = torch.where(neg_mask, d, torch.inf).amin(dim=1)
    valid = pos_mask.any(dim=1) & neg_mask.any(dim=1)
    return torch.where(valid, d_ap, 0.0), torch.where(valid, d_an, 0.0), valid


def batch_hard_mining_xbm(emb, labels, bank_emb, bank_labels, bank_valid):
    """Batch-hard mining with a cross-batch memory bank: the hardest
    positive from the batch, the hardest negative over the batch and the
    valid bank rows (entered detached)."""
    d = pairwise_sq_dists(emb)
    d_ap, pos_mask, neg_mask = _hardest_positive(d, labels)
    bank_emb = bank_emb.detach()
    g = emb @ bank_emb.T
    db = torch.clamp(torch.sum(emb * emb, dim=1)[:, None] - 2.0 * g
                     + torch.sum(bank_emb * bank_emb, dim=1)[None, :], min=0.0)
    neg_b = (labels[:, None] != bank_labels[None, :]) & bank_valid[None, :]
    d_an = torch.minimum(torch.where(neg_mask, d, torch.inf).amin(dim=1),
                         torch.where(neg_b, db, torch.inf).amin(dim=1))
    valid = pos_mask.any(dim=1) & (neg_mask.any(dim=1) | neg_b.any(dim=1))
    return torch.where(valid, d_ap, 0.0), torch.where(valid, d_an, 0.0), valid


def _normalized(model, images):
    emb = model(images)
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)


def _hinge(d_ap, d_an, valid, margin):
    """(mean hinge over the valid anchors, active fraction)."""
    hinge = torch.clamp(d_ap - d_an + margin, min=0.0) * valid
    n = torch.clamp(valid.sum(), min=1)
    return hinge.sum() / n, ((hinge > 0) & valid).sum() / n


def triplet_loss(model, images, labels, margin=0.2):
    """Batch-hard triplet loss over one batch: (loss, active fraction —
    the share of anchors whose hinge is above 0)."""
    emb = _normalized(model, images)
    return _hinge(*batch_hard_mining(emb, labels), margin)


def triplet_loss_xbm(model, images, labels, bank_emb, bank_labels, bank_valid, margin=0.2):
    """Batch-hard triplet loss with the memory bank's negatives: (loss,
    (active fraction, the normalized batch embeddings, detached — what the
    caller pushes into the bank))."""
    emb = _normalized(model, images)
    loss, active = _hinge(*batch_hard_mining_xbm(emb, labels, bank_emb, bank_labels,
                                                 bank_valid), margin)
    return loss, (active, emb.detach())


def train_step(model, opt, images, labels, margin=0.2):
    """One step of ``triplet_loss`` and ``opt`` (``optim.AdamW``) on
    ``model`` in place. Returns (loss, active fraction)."""
    return run_step(opt, lambda: triplet_loss(model, images, labels, margin))


def train_step_xbm(model, opt, images, labels, bank_emb, bank_labels, bank_valid,
                   margin=0.2):
    """One step of ``triplet_loss_xbm``. Returns (loss, active fraction,
    normalized batch embeddings)."""
    loss, (active, emb) = run_step(opt, lambda: triplet_loss_xbm(
        model, images, labels, bank_emb, bank_labels, bank_valid, margin))
    return loss, active, emb


class MemoryBank:
    """Host-side FIFO ring of recent (embedding, label) pairs. A fixed
    ``capacity`` keeps the step's shapes static; ``valid`` masks the
    unfilled tail until the ring wraps. ``arrays()`` returns (embeddings,
    labels, valid) as tensors on ``device`` (None: the card)."""

    def __init__(self, capacity, dim, device=None):
        self.device = config.resolve_device(device)
        self.emb = np.zeros((capacity, dim), np.float32)
        self.labels = np.full((capacity,), -1, np.int32)
        self.valid = np.zeros((capacity,), bool)
        self._ptr = 0

    def arrays(self):
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (self.emb, self.labels, self.valid))

    def push(self, emb, labels):
        emb = np.asarray(emb, np.float32)
        labels = np.asarray(labels, np.int32)
        cap = self.emb.shape[0]
        n = min(len(labels), cap)
        emb, labels = emb[-n:], labels[-n:]
        idx = (self._ptr + np.arange(n)) % cap
        self.emb[idx] = emb
        self.labels[idx] = labels
        self.valid[idx] = True
        self._ptr = int((self._ptr + n) % cap)


def finetune_facenet(images, labels, epochs=5, batch_size=32, margin=0.2,
                     learning_rate=1e-5, casia=False, mesh=None, seed=0, params=None,
                     model=None, bank_size=0, *, device=None):
    """Fine-tune FaceNet (InceptionResnetV1) on (images [N, H, W, 3] uint8
    BGR, 160 px for FaceNet, labels [N] int): BGR -> RGB and (x - 127.5) /
    128, a ``default_rng(seed)`` shuffle per epoch, the ragged tail batch
    dropped, ``optax.adamw(learning_rate)`` over every leaf — the BatchNorm
    statistics included, as the JAX loop trains them (their var can go
    negative and NaN the forward, as ROADMAP.md records of the reference).

    ``params``: a JAX-layout tree loaded into the model (None: the
    converted checkpoint, or seeded weights with a note when it is absent).
    ``model``: an ``nn.Module`` to train in FaceNet's place (NCHW float
    input -> [B, D] embeddings). ``bank_size > 0`` adds the memory bank's
    negatives (``MemoryBank`` of that many recent embeddings).
    ``mesh``: the JAX loop's data mesh; anything but None raises
    (``optim.refuse_mesh``). ``device``: None means the card.

    Returns (the trained tree in the JAX layout, numpy arrays; history of
    per-epoch mean losses)."""
    from ..models import facenet as FN
    from ..models.wrappers import _resolve_checkpoint

    refuse_mesh(mesh)
    device = config.resolve_device(device)
    if model is None:
        if params is None:
            params = _resolve_checkpoint("facenet_casia" if casia else "facenet_vgg")
        model = FN.InceptionResnetV1() if params is not None else FN.InceptionResnetV1.seeded(0)
    if params is not None:
        model.load_state_dict(facenet_from_jax(params), strict=True)
    model = model.to(device)
    opt = AdamW(leaves(model), learning_rate)
    images = np.asarray(images)
    labels = np.asarray(labels, np.int32)
    bank = None
    if bank_size:
        with torch.no_grad(), config.model_call():
            dim = model(torch.zeros((1, 3) + images.shape[1:3], device=device)).shape[-1]
        bank = MemoryBank(bank_size, dim, device)

    def run_batch(idx):
        rgb = torch.from_numpy(np.ascontiguousarray(images[idx][..., ::-1])).to(device)
        x = FN.preprocess_uint8(rgb).permute(0, 3, 1, 2).contiguous()
        y = torch.from_numpy(labels[idx]).to(device)
        if bank is None:
            return train_step(model, opt, x, y, margin)[0]
        loss, _, emb = train_step_xbm(model, opt, x, y, *bank.arrays(), margin)
        bank.push(emb.cpu().numpy(), labels[idx])
        return loss

    history = run_epochs(len(images), epochs, batch_size, seed, run_batch)
    return facenet_to_jax(model.state_dict()), history
