from vision_kit_tpu_torch.ops.boxes import (
    box_area,
    box_iou_aligned,
    box_iou_pairwise,
    clip_boxes,
    cxcywh_to_xyxy,
    xywh_to_cxcywh,
    xywh_to_xyxy,
    xywhn_to_xyxy,
    xyxy_to_cxcywh,
    xyxy_to_xywh,
    xyxy_to_xywhn,
)
from vision_kit_tpu_torch.ops.letterbox import (
    letterbox_device,
    letterbox_np,
    letterbox_params,
    scale_coords,
)
from vision_kit_tpu_torch.ops.nms import batched_nms, postprocess

__all__ = [
    "box_area",
    "box_iou_aligned",
    "box_iou_pairwise",
    "clip_boxes",
    "cxcywh_to_xyxy",
    "xywh_to_cxcywh",
    "xywh_to_xyxy",
    "xywhn_to_xyxy",
    "xyxy_to_cxcywh",
    "xyxy_to_xywh",
    "xyxy_to_xywhn",
    "letterbox_params",
    "letterbox_device",
    "letterbox_np",
    "scale_coords",
    "batched_nms",
    "postprocess",
]
