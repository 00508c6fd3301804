"""Networks: positional encoding, ResNet encoder, spatial encoder, ResnetFC."""
