"""Core of the port: adaptive-rank LoRA adapters (lora.py)."""
