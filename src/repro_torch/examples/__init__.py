"""Walkthroughs of the port, run as ``python -m repro_torch.examples.<name>``
(on the card by default; ``--device cpu`` runs the plain versions)."""
