from vision_kit_tpu_torch.models.architectures import YOLOV5, YOLOV7, build_model

__all__ = ["YOLOV5", "YOLOV7", "build_model"]
