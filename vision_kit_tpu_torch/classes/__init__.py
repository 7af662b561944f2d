from vision_kit_tpu_torch.classes.coco import COCO

__all__ = ["COCO"]
