"""NHWC models: ConvNeXt, ResNet, the multi-task heads, weight carry."""
