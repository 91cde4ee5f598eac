"""Training (counterpart of videotofaces_tpu/train/): the ViT classifier
step, triplet fine-tuning of FaceNet with the memory bank, and YOLOv3 head
and full fine-tuning, on one device or over a mesh (parallel/mesh.py): the
data-parallel step makers (``make_sharded_triplet_step``,
``make_sharded_xbm_step``, ``make_sharded_head_step``,
``make_sharded_full_step``), the loops' ``mesh=``, and the classifier's
step over a ``("data", "model")`` mesh (``make_sharded_train_step``)."""

from .trainer import ViTClassifier, create_train_state, make_sharded_train_step  # noqa: F401
from .triplet import (MemoryBank, batch_hard_mining,  # noqa: F401
                      batch_hard_mining_xbm, finetune_facenet,
                      make_sharded_triplet_step, make_sharded_xbm_step,
                      triplet_loss, triplet_loss_xbm)
from .detector import (finetune_yolo_full, finetune_yolo_head,  # noqa: F401
                       layerwise_tx, make_sharded_full_step,
                       make_sharded_head_step)
