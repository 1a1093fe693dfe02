"""The reference's ``examples/``, ported: run each as
``python -m repro_torch.examples.<name>`` (``quickstart``, ``chain_cnn``,
``chain_lm``, ``serve_lm``).  Each takes ``--device`` (``cuda`` by
default; without a card it exits with ``export.resolve_device``'s error)."""
