"""The experiment drivers, each run as ``python -m scasml_gp_torch.scripts.<name>``.

Ports of the JAX package's drivers under ``scripts/``, with their flags,
defaults and output files, plus ``--device`` (default ``cuda``; a missing
CUDA device is an error):

- ``run_all``             the campaign: equation x dim x variant x harness,
                          one tune or fit per (equation, dim), merged into
                          ``<save-path>/run_all_summary.json``.
- ``summarize_campaign``  the markdown tables of a ``run_all_summary.json``.
- ``throughput``          MLP full-history generator evaluations per second
                          per device (and the 'data'-sharded rollout under
                          ``torchrun``).
- ``high_dim``            d = 250 runs of GradDependentNonlinear, Allen-Cahn
                          and HJB.
- ``stretch_d250``        HJB and Allen-Cahn at d = 250 at full size, and the
                          sharded-against-unsharded mesh check on gloo ranks.
"""
