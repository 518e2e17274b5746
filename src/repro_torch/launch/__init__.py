"""Launchers (``python -m repro_torch.launch.serve``, ``.train``,
``.dryrun``), the meshes and the card's roofline constants, and the
collective accounting the dry run reads."""
