"""Model families of the port: DeOldify (ResNet body) and DDColor
(ConvNeXt encoder), plus the flax weight bridge."""
