"""Training (counterpart of videotofaces_tpu/train/): the ViT classifier
step, triplet fine-tuning of FaceNet with the memory bank, and YOLOv3 head
and full fine-tuning, on one device. The sharded step makers of the JAX
package (``make_sharded_*``) are not ported yet."""

from .trainer import ViTClassifier, create_train_state  # noqa: F401
from .triplet import (MemoryBank, batch_hard_mining,  # noqa: F401
                      batch_hard_mining_xbm, finetune_facenet,
                      triplet_loss, triplet_loss_xbm)
from .detector import (finetune_yolo_full, finetune_yolo_head,  # noqa: F401
                       layerwise_tx)
