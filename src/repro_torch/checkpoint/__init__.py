"""Checkpointing: async save/restore of training state."""
