"""The paper's own CNN image classifier (LeNet-style, used for CIFAR10 /
CelebA / FEMNIST in MoDeST Table 3). Used by the protocol-form experiments."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-cnn",
    family="cnn",
    cnn_channels=(6, 16),
    cnn_classes=10,
    cnn_image=(32, 32, 3),
    param_dtype="float32",
    citation="MoDeST Table 3 — CNN (LeNet)",
)
