"""Training substrate: optimizer, train step, gradient compression
(counterpart of :mod:`repro.train`)."""
