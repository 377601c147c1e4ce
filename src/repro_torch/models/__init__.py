"""Model stack of the port: GQA attention, MLP and the attn-block
transformer."""
