"""The benchmark of ``uf3_tpu_torch``: MD of UF3 potentials on the card.
See README.md."""
