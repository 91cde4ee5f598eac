from .pbar import tqdm  # noqa: F401
from .image import resize_keep_ratio, crop_to_area  # noqa: F401
