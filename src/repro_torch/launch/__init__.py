"""Launchers: the serving CLI (``launch.serve``) and the training CLI
(``launch.train``)."""
