from vision_kit_tpu_torch.models.architectures import YOLOV5, YOLOV7, build_model
from vision_kit_tpu_torch.models.backbones import CSPDarknet, V7Backbone
from vision_kit_tpu_torch.models.heads import YoloV5Head, YoloV7Head
from vision_kit_tpu_torch.models.necks import PAFPN, PAFPNELAN

__all__ = [
    "YOLOV5",
    "YOLOV7",
    "build_model",
    "CSPDarknet",
    "V7Backbone",
    "YoloV5Head",
    "YoloV7Head",
    "PAFPN",
    "PAFPNELAN",
]
