"""One module a loop, ``<loop>.py`` with ``drive(call, seconds)``, named by
a traffic file's ``loop``."""
