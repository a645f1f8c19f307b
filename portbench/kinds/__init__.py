"""The traffic kinds: ``kinds/<kind>.py`` drives every mix whose
``traffic/<mix>.json`` names that kind (its class ``Traffic``)."""
