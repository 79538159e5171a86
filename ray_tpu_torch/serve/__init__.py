"""ray_tpu_torch.serve — model serving on the card (LLM engine and server)."""
