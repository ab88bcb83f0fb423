"""The observability walkthroughs of the port: the traced fleet
(``demo.main``), the health plane's straggler loop
(``health_demo.main``) and the paged fleet under the serving ledger
(``serve_demo.main``)."""
