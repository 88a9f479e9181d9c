"""Host IO of the PyTorch port: datasets, images (PNG, JPEG, GIF and BMP
in; PNG and JPEG out) and arrays (npy, npz, bl2, dcz)."""

from depth_completion_tpu_torch.io.codecs import (
    NPARRAY_EXTS,
    is_array_path,
    load_array,
    load_arrays,
    save_array,
)
from depth_completion_tpu_torch.io.dataset import (
    DATASET_DIR_NAME_IMAGE,
    DATASET_DIR_NAME_SEGMASK,
    DATASET_DIR_NAME_SPARSE,
    RESULT_DIR_NAME_DENSE,
    RESULT_DIR_NAME_VIS,
    find_dataset_dirs,
    find_file_with_exts,
    find_img_paths,
    is_dataset_dir,
)
from depth_completion_tpu_torch.io.image import (
    image_size,
    is_img_file,
    load_img_array,
    load_img_arrays,
    save_img_array,
    to_depth,
    to_segmask,
)

__all__ = [
    "NPARRAY_EXTS",
    "is_array_path",
    "load_array",
    "load_arrays",
    "save_array",
    "DATASET_DIR_NAME_IMAGE",
    "DATASET_DIR_NAME_SEGMASK",
    "DATASET_DIR_NAME_SPARSE",
    "RESULT_DIR_NAME_DENSE",
    "RESULT_DIR_NAME_VIS",
    "find_dataset_dirs",
    "find_file_with_exts",
    "find_img_paths",
    "is_dataset_dir",
    "image_size",
    "is_img_file",
    "load_img_array",
    "load_img_arrays",
    "save_img_array",
    "to_depth",
    "to_segmask",
]
