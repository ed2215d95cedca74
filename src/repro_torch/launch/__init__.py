"""Port of ``src/repro/launch``: the serving launcher (the train and dry-run launchers wait, ROADMAP A16)."""
