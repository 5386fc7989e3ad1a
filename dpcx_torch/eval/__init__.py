"""Evaluation metrics (the parts the predicted-pose loss reads)."""
