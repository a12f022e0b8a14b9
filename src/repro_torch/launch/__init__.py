"""The port's launchers: the patch devices of the sharded stream (`mesh`),
supernet training (`train`) and the serving loop (`serve`)."""
