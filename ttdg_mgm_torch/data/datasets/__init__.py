"""The legacy domain-adaptation datasets' loaders: foggy Cityscapes,
Pascal-VOC-layout sets (Clipart1k, Watercolor) and the fetal-ultrasound
tree.  This package's own copy of ``ttdg_mgm_tpu/data/datasets``."""

from ttdg_mgm_torch.data.datasets.cityscapes_foggy import (load_cityscapes_foggy_instances,
                                                           register_all_cityscapes_foggy)
from ttdg_mgm_torch.data.datasets.fetus import FetusDataset, load_fetus_dicts

__all__ = [
    "load_cityscapes_foggy_instances",
    "register_all_cityscapes_foggy",
    "FetusDataset",
    "load_fetus_dicts",
]
