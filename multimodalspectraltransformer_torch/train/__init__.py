"""Training: the loss, AdamW with the plateau schedule, the train step, the
loop and its checkpoints; the molecule generator and the self-improvement
cycle; and the CLIP tokenizer."""
