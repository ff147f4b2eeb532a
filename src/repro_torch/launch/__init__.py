"""Command-line entry points: ``serve`` (prefill + decode of a decoder LM),
``train`` (AdamW training of an LM zoo arch with checkpoints and resume),
``lm_federated`` (federated LoRA training of a decoder LM),
``serve_quantized`` (the int4 adapter download and multi-tenant serving)
and ``quickstart`` (the paper's FL round and its sparse, mixed-rank,
async and DP modes); and the paper's experiment harness,
``fl_experiment`` (one FL run with test accuracy, round bytes and TCC)."""
