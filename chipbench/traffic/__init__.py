"""Traffic: one general driver a kind of traffic (``<driver>.py``) and one
data file a mix (``<traffic>.json``, naming its driver).  A new mix of an
existing driver is a new data file."""
