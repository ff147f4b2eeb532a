"""Command-line entry points: ``serve`` (prefill + decode of a decoder LM)
and ``lm_federated`` (federated LoRA training of a decoder LM)."""
