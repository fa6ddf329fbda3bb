"""Analysis over the port's traces (twin of ``repro.analysis``; so far
only the shape walk the autotune sweep needs, ``traces.shape_requests``)."""
