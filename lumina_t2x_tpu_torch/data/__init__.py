"""Training data (counterpart of `lumina_t2x_tpu/data`): meta datasets over
image-caption annotations (`dataset.py`), aspect buckets and crops
(`imgproc.py`), batch assembly (`loader.py`), the path reader
(`data_reader.py`) and the native JPEG/PNG decoder's binding
(`native_loader.py`)."""

from .dataset import (DataBriefReportException, ItemProcessor, MetaDataset, T2IItemProcessor,
                      TokenizedT2IItemProcessor, resumable_sampler_indices)
from .imgproc import (center_crop, center_crop_arr, choose_bucket, generate_crop_size_list,
                      match_bucket, to_latent_input, var_center_crop)
from .loader import (batched, bucket_batched, bucket_batched_global, collate_image_label,
                     list_imagenet_folder, threaded_prefetch)

__all__ = [
    "MetaDataset", "ItemProcessor", "T2IItemProcessor", "TokenizedT2IItemProcessor",
    "DataBriefReportException", "resumable_sampler_indices",
    "generate_crop_size_list", "var_center_crop", "center_crop", "center_crop_arr",
    "match_bucket", "choose_bucket", "to_latent_input",
    "threaded_prefetch", "batched", "bucket_batched", "bucket_batched_global",
    "list_imagenet_folder", "collate_image_label",
]
