"""The port's counterparts of the JAX package's profiling tools under ``tools/``.

- :mod:`.distill_spec_pair` — ``tools/distill_spec_pair.py``: a GPT-2-small
  target trained on synthetic Markov sequences and a 2-layer draft
  distilled from it, saved for speculative decoding;
- :mod:`.profile_speculative` — ``tools/profile_speculative.py``: batch-1
  plain against speculative decoding, with the distilled pair
  (``--trained``) and int8 weights (``--int8``).

Each runs as ``python -m vitef_tpu_torch.tools.<name>``, on the card unless
``--device cpu`` is given.
"""
