"""Training-side helpers of the port (so far the CLIP tokenizer)."""
