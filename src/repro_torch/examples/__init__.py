"""repro_torch.examples -- twins of the repository's ``examples/``, run as
``python -m repro_torch.examples.<name>``: ``quickstart`` and
``multi_tenant`` (the simulator), ``mixed_mode_dag`` (the paper's DAG on the
hand kernels), ``serve_lm`` (the simulator study, then a small decoder
served on the threaded runtime) and ``train_lm`` (a ~100M-parameter model
trained with AdamW, a cosine schedule and async checkpoints)."""
