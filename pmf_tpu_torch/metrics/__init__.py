from .iou import IOUEval, confusion_matrix
