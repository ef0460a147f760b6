"""Bytes on disk of the ``l_comment`` column per row written in the
window: what the writer's string codecs make of the widest column, from
the page lengths of the column metas that ``write_file`` returns."""


def read(ctx):
    rows = sum(a["rows"] for _p, a in ctx.done if "l_comment" in a.get("column_bytes", {}))
    if not rows:
        return None
    return sum(a["column_bytes"]["l_comment"] for _p, a in ctx.done
               if "l_comment" in a.get("column_bytes", {})) / rows
