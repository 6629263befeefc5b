"""The MLP, CNN and softmax-regression classifiers as torch.nn modules."""
from .baselines import SoftmaxRegression  # noqa: F401
from .cnn import CNN, adaptive_avg_pool_2d  # noqa: F401
from .mlp import MLP, mlp_dims  # noqa: F401
