"""Fleet helpers the serving layer uses (the port's own copy of
``repro.pool.sharing.intersect_hot_sets``)."""
