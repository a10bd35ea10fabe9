"""NHWC models: the backbone zoo, the heads, Classifier and
CoordinateRegressor, the OCR nets, test-time inference and weight carry
(``models/convert.py``)."""

from spine_vision_torch.models.backbone import (
    BACKBONES,
    BackboneFactory,
    create_backbone,
    get_feature_dim,
    list_backbones,
)
from spine_vision_torch.models.classifier import (
    Classifier,
    CoordinateRegressor,
    coords_to_pixels,
    make_coordinate_loss_fn,
    make_multitask_loss_breakdown_fn,
    make_multitask_loss_fn,
)
from spine_vision_torch.models.convnext import CONVNEXT_CONFIGS, ConvNeXt
from spine_vision_torch.models.efficientnet import EfficientNet, MobileNetV3
from spine_vision_torch.models.heads import (
    AttentionHead,
    ConvHead,
    HeadConfig,
    HeadFactory,
    LinearHead,
    MLPHead,
    MultiTaskHead,
    ResidualHead,
    create_head,
    get_activation,
)
from spine_vision_torch.models.inference import (
    classifier_test_inference,
    regressor_test_inference,
)
from spine_vision_torch.models.resnet import RESNET_CONFIGS, ResNet
from spine_vision_torch.models.swin import SwinTransformer
from spine_vision_torch.models.textdet import TextDetectionNet, extract_boxes_from_probmap
from spine_vision_torch.models.textrec import (
    VIETNAMESE_CHARSET,
    TextRecognitionNet,
    charset_size,
    ctc_greedy_decode,
)
from spine_vision_torch.models.vit import ViT

__all__ = [
    "BACKBONES",
    "BackboneFactory",
    "CONVNEXT_CONFIGS",
    "RESNET_CONFIGS",
    "AttentionHead",
    "Classifier",
    "ConvHead",
    "ConvNeXt",
    "CoordinateRegressor",
    "EfficientNet",
    "HeadConfig",
    "HeadFactory",
    "LinearHead",
    "MLPHead",
    "MobileNetV3",
    "MultiTaskHead",
    "ResNet",
    "ResidualHead",
    "SwinTransformer",
    "TextDetectionNet",
    "TextRecognitionNet",
    "VIETNAMESE_CHARSET",
    "ViT",
    "charset_size",
    "classifier_test_inference",
    "coords_to_pixels",
    "create_backbone",
    "create_head",
    "ctc_greedy_decode",
    "extract_boxes_from_probmap",
    "get_activation",
    "get_feature_dim",
    "list_backbones",
    "make_coordinate_loss_fn",
    "make_multitask_loss_breakdown_fn",
    "make_multitask_loss_fn",
    "regressor_test_inference",
]
