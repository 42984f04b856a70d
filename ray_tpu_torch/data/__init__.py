"""ray_tpu_torch.data: streaming dataset engine (counterpart of
`ray_tpu.data`; reference: python/ray/data/) — lazy plans, fused per-block
tasks, bounded-window streaming. Host-side numpy throughout: nothing here
imports torch (`Dataset.iter_torch_batches` does, when called)."""

from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.dataset import Dataset, GroupedData
from ray_tpu_torch.data.read_api import (from_arrow, from_huggingface,
                                         from_items, from_numpy, from_pandas,
                                         from_torch, range, read_binary_files,
                                         read_csv, read_images, read_json,
                                         read_numpy, read_parquet, read_sql,
                                         read_text, read_tfrecords)

__all__ = [
    "Block", "Dataset", "GroupedData", "range", "from_items", "from_numpy",
    "from_pandas", "read_parquet", "read_csv", "read_json", "read_text",
    "read_binary_files", "read_numpy", "read_images", "read_tfrecords",
    "read_sql", "from_arrow", "from_torch", "from_huggingface",
]
from ray_tpu_torch.data.read_api import read_webdataset  # noqa: E402,F401

__all__.append("read_webdataset")
