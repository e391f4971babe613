"""Dataset and loader factories (port of ``instancediff_tpu/data``, the
``SpeckleMed`` and ``Synthetic`` modes): the train loader of ``trainUM`` and
``distill`` and the test and validation loaders of ``trainUM`` and
``testUM``."""

from .loader import DataLoader, collate
from .med_dataset import DEFAULT_TYPE_MAP, SpeckleMedDataset, create_SpeckleMedDataset
from .sampler import DistIterSampler
from .synthetic import SyntheticMedDataset, make_synthetic_dataset, write_synthetic_index


def create_dataset(dataset_opt):
    mode = dataset_opt["mode"]
    if mode == "SpeckleMed":
        return create_SpeckleMedDataset(dataset_opt)
    if mode == "Synthetic":
        return make_synthetic_dataset(dataset_opt)
    raise NotImplementedError(f"Dataset mode [{mode}] is not recognized.")


def create_dataloader(dataset, dataset_opt, sampler=None, world_size: int = 1):
    """The train phase: this rank's part of the option block's global batch
    (``batch_size // world_size``, which must divide exactly) in
    ``sampler``'s order (the dataset's without one), a short last batch
    dropped. Test/validation: the block's batch size (1 by default), in
    order, the last batch kept."""
    if dataset_opt.get("phase") == "train":
        batch_size = dataset_opt["batch_size"]
        if batch_size % world_size:
            raise ValueError(f"batch_size {batch_size} does not divide over {world_size} ranks")
        return DataLoader(dataset, batch_size=batch_size // world_size, sampler=sampler,
                          drop_last=True)
    return DataLoader(dataset, batch_size=dataset_opt.get("batch_size") or 1)


__all__ = ["DEFAULT_TYPE_MAP", "DataLoader", "DistIterSampler", "SpeckleMedDataset",
           "SyntheticMedDataset", "collate", "create_SpeckleMedDataset", "create_dataloader",
           "create_dataset", "make_synthetic_dataset", "write_synthetic_index"]
