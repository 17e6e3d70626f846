"""HDep post-processing flows — moved to :mod:`repro_torch.hercule.api`.

The HDep object flavors live in :mod:`repro_torch.hercule.api` as typed
ObjectKinds (``amr_tree``, ``analysis``, ``reduced``): each kind declares
its record naming schema, write/read codecs and assembly logic, and every
read routes through an indexed :class:`~repro_torch.hercule.api.ContextView`.

The legacy free functions that used to live here
(``write_domain_tree`` / ``read_domain_tree`` / ``domains_in`` /
``write_analysis`` / ``read_analysis`` / ``write_reduced`` /
``read_reduced`` / ``reducers_in``) went through the DESIGN.md §11
deprecation countdown and are gone. Call the unified API instead::

    from repro_torch.hercule import api
    api.write_object(ctx, "amr_tree", domain, tree)
    tree   = api.read_object(db, step, "amr_tree", domain)
    stats  = api.read_object(db, step, "analysis", domain)
    arrays = api.read_object(db, step, "reduced", domain, reducer=name)
    api.AMR_TREE.domains_in(db.view(step))
    api.REDUCED.reducers_in(db.view(step))
"""
