"""The port's launchers: the patch devices of the sharded stream (`mesh`),
training (`train`: the supernet, and an LM's smoke run), the serving loop
(`serve`), and the LM side's step builders (`steps`), cost model
(`costmodel`) and roofline terms (`roofline`)."""
