"""Launchers: the training launcher (``train``) and the serving launcher
(``serve``)."""
