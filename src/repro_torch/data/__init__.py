from repro_torch.data.partition import partition_by_classes  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    ImageDataset, cifar_like, cifar_like_split, fmnist_like, fmnist_like_split,
    make_image_dataset, make_split_dataset)
