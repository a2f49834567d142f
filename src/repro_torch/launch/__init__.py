"""Analysis and reporting on the card: work models and roofline terms
(``roofline``), the engine's dry run (``dryrun_engine``) and the one-shot
obs report (``obs_report``)."""
