"""Raw-archive converters: PCD clouds and OpenLabel labels -> infos pkl."""
