"""The command line: `python -m weatherconverter_tpu_torch.cli.main`."""
