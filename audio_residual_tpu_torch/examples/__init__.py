"""The repo's experiment drivers (``examples/`` beside the JAX package) on the
card: one module a script, named as the script without its leading digit, so
``python -m audio_residual_tpu_torch.examples.<name>`` runs it.

  * :mod:`.full_workflow` -- the whole ResiDual experiment in one command
    (PCA -> injection -> λ-training -> K-fold eval -> baseline -> linear
    probe -> table and figures), ``WORKFLOW {json}``;
  * :mod:`.analyze_clap_attention`, :mod:`.apply_residual_to_clap`,
    :mod:`.evaluate_and_compare` -- the three notebook drivers;
  * :mod:`.esc50_api` -- zero-shot ESC-50 through ``CLAPModule``;
  * :mod:`.perf_breakdown` -- per-stage times of the zero-shot path,
    ``PERF_BREAKDOWN {json}``.

Each ``main(argv=None, ...)`` returns what it prints and runs on the card
unless called with ``device="cpu"``. ``launch/`` holds the CLAP training and
evaluation launches.
"""
