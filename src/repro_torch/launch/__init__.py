"""Command-line entry points: ``serve`` (prefill + decode of a decoder LM),
``train`` (AdamW training of an LM zoo arch with checkpoints and resume)
and ``lm_federated`` (federated LoRA training of a decoder LM)."""
