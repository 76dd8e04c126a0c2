"""Launchers: the serving driver (``launch.serve``) and, for now, only the
reduced-config helper of the training driver (``launch.train``)."""
