"""The MLP, CNN and softmax-regression classifiers as torch.nn modules."""
from .baselines import SoftmaxRegression  # noqa: F401
from .cnn import CNN  # noqa: F401
from .mlp import MLP  # noqa: F401
