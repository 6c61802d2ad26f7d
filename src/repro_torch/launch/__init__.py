"""Entry points of the port: the serving launcher and its tenant zoo."""
