"""Launch-side analysis for one card: its share of the reference's
production mesh (``mesh``), one card's cells (``input_specs``), the H100
roofline and parameter count (``roofline``) and the fit planner
(``dryrun``). Nothing is imported here, so ``python -m`` runs each module
as ``__main__`` once."""
