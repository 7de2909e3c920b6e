from .acc import AccEval, topk_accuracy
from .iou import IOUEval, confusion_matrix, iou_from_confusion
