"""Datasets of the port, and the choice among them by name."""

DATASETS = ("coco", "cityscapes", "synthetic")


def make_dataset(cfg, name: str, training: bool):
    """The dataset ``name`` of ``cfg`` (files under ``dataset.dataset_path``,
    ``image_set`` when training, else ``test_image_set``); 'synthetic' is the
    in-memory ``SyntheticDataset``, 64 scenes to train on or 8 to evaluate,
    as the JAX entries make it."""
    if name == "coco":
        from upsnet_torch.data.coco import COCOPanoptic

        return COCOPanoptic(cfg, training=training)
    if name == "cityscapes":
        from upsnet_torch.data.cityscapes import Cityscapes

        return Cityscapes(cfg, training=training)
    if name == "synthetic":
        from upsnet_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(cfg, num_images=64 if training else 8, training=training)
    raise ValueError(f"dataset {name!r}: expected one of {DATASETS}")
