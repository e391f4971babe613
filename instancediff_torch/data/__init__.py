"""Dataset and loader factories (port of ``instancediff_tpu/data``, the
``SpeckleMed`` mode): the test and validation loaders of ``testUM``."""

from .loader import DataLoader, collate
from .med_dataset import DEFAULT_TYPE_MAP, SpeckleMedDataset, create_SpeckleMedDataset


def create_dataset(dataset_opt):
    mode = dataset_opt["mode"]
    if mode == "SpeckleMed":
        return create_SpeckleMedDataset(dataset_opt)
    if mode == "Synthetic":
        raise NotImplementedError("the Synthetic dataset draws its degradations with "
                                  "jax.random; it comes with the training port")
    raise NotImplementedError(f"Dataset mode [{mode}] is not recognized.")


def create_dataloader(dataset, dataset_opt):
    """A test/validation loader: the option block's batch size (1 by
    default), in order, the last batch kept."""
    if dataset_opt.get("phase") == "train":
        raise NotImplementedError("the training loader comes with the training port")
    return DataLoader(dataset, batch_size=dataset_opt.get("batch_size") or 1)


__all__ = ["DEFAULT_TYPE_MAP", "DataLoader", "SpeckleMedDataset", "collate",
           "create_SpeckleMedDataset", "create_dataloader", "create_dataset"]
