"""The MLP and CNN classifiers as torch.nn modules."""
from .cnn import CNN  # noqa: F401
from .mlp import MLP  # noqa: F401
