"""The benchmark of ``isingmontecarlo_tpu_torch`` (see ``README.md``)."""
