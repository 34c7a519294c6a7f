from .render import render_bboxes, annotate_detections, render_text_annotated_bboxes

__all__ = ["render_bboxes", "annotate_detections", "render_text_annotated_bboxes"]
