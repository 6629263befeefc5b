"""Training of the MLP and CNN: loaders and split, the Trainer, the
TrainingManager and the checkpoint reader and writer."""
from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .data import (ArrayDataLoader, build_melspec_dataloader,  # noqa: F401
                   build_melspec_train_val, build_mfcc_train_val,
                   stratified_split)
from .manager import TrainingManager  # noqa: F401
from .trainer import ReduceLROnPlateau, Trainer  # noqa: F401
