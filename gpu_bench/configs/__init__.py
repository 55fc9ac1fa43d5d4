"""One module and one JSON file per configuration, found by its name.

The JSON file is the configuration as it runs (sizes, source, cuts);
the module of the same name builds its matrix from the JSON and the seed
(``build``) and gives its frozen byte count (``bytes_moved``)."""
