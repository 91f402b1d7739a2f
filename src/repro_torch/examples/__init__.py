"""The port's walkthroughs, each the counterpart of a JAX example in the
repository's `examples/`:

  python -m repro_torch.examples.quickstart           [--device cpu]
  python -m repro_torch.examples.streaming_clusters   [--device cpu]
  python -m repro_torch.examples.crash_recovery       [--ha] [--device cpu]
  python -m repro_torch.examples.observability        [--ha] [--device cpu]
  python -m repro_torch.examples.retrieval_index      [--quick] [--out F]
  python -m repro_torch.examples.serve_lm             [--device cpu]
  python -m repro_torch.examples.data_curation        [--device cpu]
  python -m repro_torch.examples.train_lm             [--full-100m] [--device cpu]

Each runs on the card unless `--device cpu` is passed, and its `main()`
returns the numbers it prints.
"""
