"""CLI entry points mirroring the reference binaries' flags and byte formats
(counterpart of :mod:`modem_tpu.cli`).

``python -m modem_tpu_torch.cli.modulate`` and ``python -m
modem_tpu_torch.cli.demodulate`` reproduce `modulate`/`demodulate`: the same
flags, defaults, scheme table and binary formats, block-streamed with an
explicit state carry, plus ``--device`` (default ``cuda``). ``python -m
modem_tpu_torch.cli.link`` is the coded link's ``tx``/``rx`` pair.
"""
