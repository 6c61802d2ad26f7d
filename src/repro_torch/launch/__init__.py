"""Entry points of the port: serving (``serve`` and its tenant ``zoo``),
training (``train``), meshes (``mesh``) and the multi-pod dry run
(``dryrun``)."""
