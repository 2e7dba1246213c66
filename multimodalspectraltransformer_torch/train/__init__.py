"""Training: the loss, AdamW with the plateau schedule, the train step, the
loop and its checkpoints; and the CLIP tokenizer."""
