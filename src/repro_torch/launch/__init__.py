"""Launchers of the port (counterpart of :mod:`repro.launch`): the
``profile_run`` command-line entry point."""
