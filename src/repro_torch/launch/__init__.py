"""The port's launchers: the meshes (`mesh`: the patch devices of the sharded
stream, and the LM meshes over a fake process group), training (`train`: the
supernet, and an LM's smoke run), the serving loop (`serve`), and the LM
side's step builders and lowering (`steps`), cost model (`costmodel`),
roofline terms (`roofline`), one rank's counts (`counters`), the dry run
(`dryrun`) and its tables (`report`)."""
